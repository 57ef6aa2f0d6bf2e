// Standalone integer LayerNorm kernels on int8 codes (ops/intln.py).
//
// Replace the Pallas kernels p2vit_tpu/ops/intln.py:int_ln_requant
// (_kernel) and int_res_ln_requant (_res_kernel).
//
//   int_ln_requant:     x = codes·mask;  out = clip(round(LN(x)·ratio))
//   int_res_ln_requant: res = clip(round((a·s_a + b·s_b)·inv_s_out)),
//                       ln  = clip(round(LN(res·mask)·ratio))
//
// LN is p2v::ln_row / ln_elem (ops/intln.ln_mn_chain) over the row's true
// width c_true; the wrapper zero-pads C to a multiple of 16, and zero vectors
// past c_true make those columns add nothing to the row sums.
//
// Bound on the H100: the bytes are 2 (int_ln_requant) or 4 (the residual
// kernel) per element, but the element chain is ~29 (~44) SASS
// instructions, so the SMs' issue rate, not memory, sets the pace (2.0–3.2×
// the byte bound at Swin-T's stages 0–1). The design spends nothing per
// element that the chain does not need:
// * a plan sized to C (LnPlan, mirrored by ops/intln.ln_plan): G lanes per
//   row (G a power of two, 2..32, the fewest with at most 3 chunks a lane),
//   so 32/G rows share a warp and each row reduction takes log2 G shuffle
//   steps; lane l of a row owns the 16-byte chunks l, l + G, ... (K of them,
//   K from {1, 2, 3, 4, 6, 8, 10}; chunks past the row are idle); at C = 96,
//   G = 2 and K = 3, every lane busy;
// * one read of every operand and one write of every output, as 16-byte
//   vector loads and stores (streaming, evict-first); the codes stay in
//   registers between the sums and the LN pass; the residual code is
//   computed once and its packed bytes kept for the LN pass; a persistent
//   grid (SMs × resident CTAs: 3 at K ≤ 3) whose CTAs take blocks of 256/G
//   rows in turn, each block's loads issued before the vectors are staged
//   or as the previous block ends (a register prefetch a whole LN pass
//   ahead measured no faster, and cost registers);
// * the per-column vectors staged in shared memory once per CTA as float4s
//   ({mask, w_os, b_os, ratio}, and for the residual {s_a, s_b, inv_s_out,
//   mask}), kLd = 17 float4s a chunk: a lane addresses its chunk's 16 with
//   immediate offsets, the G lanes of a row hit distinct banks, and the
//   rows of a warp share the words (broadcast);
// * the LN chain of p2v::ln_code with two exact rewrites (ln_code_fast):
//   2^N and 2^-N from a's exponent bits in five integer operations, and,
//   where every ratio is 1, round(y), the clip and the byte in one
//   saturating conversion (three instructions fewer, measured 4–6 % less
//   time); both checked over all 2^32 floats on the card
//   (p2v_ln_chain_check);
// * codes to floats by a byte permute onto 1.5·2^23 and one subtraction;
//   the residual code by the biased rounding of matmul_tiles.cuh (clip,
//   + 1.5·2^23: the int8 byte is the low byte of the float's bits, and one
//   subtraction gives the float the sums take);
// * exact sums: where every mask is an integer of magnitude ≤ 8 (checked
//   per CTA while staging), |x| ≤ 1024, so a lane's Σx (≤ 160·1024 < 2^24)
//   and a chunk's Σx² (≤ 16·2^20 = 2^24) are exact float sums of integers
//   (Σx² by fmaf: x·x ≤ 2^20 is exact, the add of integers below 2^24 too);
//   a lane's Σx² is an int32 sum of chunk sums (≤ 160·2^20 < 2^31); the row
//   sums across the G lanes are int64 (Σx² reaches C·2^20 > 2^32 at
//   C = 4736). Otherwise the exact path of the plain version: each x
//   truncated to int64 and summed in int64, from a rolled loop over the row
//   as written (codes, or the residual codes just stored). Either way the
//   sums are exact integers, rounded once to float32 (row_sums);
// * NaN as the plain version makes it: a warp holding a row whose constants
//   are not finite (a row of zero codes: mean/std = 0/0) runs
//   ln_pass_exact, which casts a NaN code as .to(int8) does. The residual
//   code assumes finite scales (the wrapper's vectors are).
#include "ln_chain.cuh"

namespace {

using p2v::code_f;
using p2v::code_of;
using p2v::code_sat;
using p2v::FastSums;
using p2v::kFlip;
using p2v::ln_code_fast;
using p2v::p2n_bits;
using p2v::pack4;
using p2v::word;

constexpr int kThreads = p2v::kThreads;  // 8 warps per CTA
constexpr int kChunk = 16;               // bytes a lane loads or stores at once
constexpr int kRun = 3;                  // the chunks per lane a plan aims at
constexpr int kMaxK = 10;                // the most chunks a lane takes (C ≤ 5120)
constexpr int kLd = 17;                  // float4s a chunk of column vectors takes in shared memory

struct LnPlan {
  int g, k, nch, rows, blocks, grid, smem;
};

// The chunk count the kernel is instantiated for: the least of {1, 2, 3, 4,
// 6, 8, 10} that holds k, or 0 past 10.
__host__ __device__ constexpr int k_round(int k) {
  return k <= 4 ? (k < 1 ? 1 : k) : k <= 6 ? 6 : k <= 8 ? 8 : k <= kMaxK ? kMaxK : 0;
}

// Rows: M; cp: the padded width (multiple of 16); force_g > 0 picks G.
inline LnPlan ln_plan(int M, int cp, bool res, int sms, int per_sm, int force_g) {
  LnPlan p{};
  p.nch = cp / kChunk;
  p.g = 2;
  while (p.g < 32 && (p.nch + p.g - 1) / p.g > kRun) p.g *= 2;
  if (force_g > 0) p.g = force_g;
  p.k = k_round((p.nch + p.g - 1) / p.g);
  p.rows = kThreads / p.g;
  p.blocks = (M + p.rows - 1) / p.rows;
  p.grid = p.blocks < sms * per_sm ? p.blocks : sms * per_sm;
  p.smem = p.nch * kLd * 16 * (res ? 2 : 1);
  return p;
}

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) { return __ldcs(reinterpret_cast<const uint4*>(p)); }
__device__ __forceinline__ void st_stream(int8_t* p, uint4 v) { __stcs(reinterpret_cast<uint4*>(p), v); }

// The LN pass over a lane's chunks: codes → ln_out's row.
template <int K, bool UNIT>
__device__ __forceinline__ void ln_pass(const uint4 (&code)[K], const float4* cln, int nch, int l, int g,
                                        const p2v::LnRow& lr, int8_t* row, bool row_in) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = l + g * k;
    if (j < nch) {
      const float4* cj = cln + j * kLd;
      uint32_t out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w = word(code[k], q) ^ kFlip;
        uint32_t t[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 c4 = cj[4 * q + e];
          t[e] = ln_code_fast<UNIT>(lr, __fmul_rn(code_f(w, e), c4.x), c4.y, c4.z, c4.w);
        }
        out[q] = pack4(t);
      }
      if (row_in) st_stream(row + kChunk * j, make_uint4(out[0], out[1], out[2], out[3]));
    }
  }
}

// The LN pass of a warp holding a row whose constants are not finite, or
// any column vector that is not (rare: a row of zero codes gives
// mean/std = 0/0): p2v::ln_elem as written and code_of, element by element,
// from the row's codes in memory (the input codes, or the residual codes
// this lane just stored).
__device__ void ln_pass_exact(const int8_t* codes, const float4* cln, int nch, int l, int g, int k_max,
                              const p2v::LnRow& lr, int8_t* row, bool row_in) {
  for (int k = 0; k < k_max && row_in; ++k) {
    const int j = l + g * k;
    if (j >= nch) break;
    for (int e = 0; e < kChunk; ++e) {
      const float4 c4 = cln[j * kLd + e];
      const float x = __fmul_rn(static_cast<float>(codes[kChunk * j + e]), c4.x);
      row[kChunk * j + e] = static_cast<int8_t>(code_of(__fmul_rn(p2v::ln_elem(lr, x, c4.y, c4.z), c4.w)));
    }
  }
}

// One kernel for both entries. vecs rows (each cp floats): RES: s_a, s_b,
// inv_s_out, mask, w_os, b_os, ratio; else mask, w_os, b_os, ratio.
// RES: a and b are the operands; else a holds the codes and b is unused.
// At K ≤ 3 the registers are held to 80, for three CTAs an SM.
template <int K, bool RES>
__global__ void __launch_bounds__(kThreads, K <= 3 ? 3 : 1)
    int_ln_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, const float* __restrict__ vecs,
                  const float* __restrict__ s1p, int8_t* __restrict__ res_out, int8_t* __restrict__ ln_out, int M,
                  int cp, int c_true, int g, int blocks) {
  extern __shared__ float4 cst[];
  const int nch = cp / kChunk;
  float4* cln = cst;               // [nch][kLd]: mask, w_os, b_os, ratio
  float4* cres = cst + kLd * nch;  // RES, [nch][kLd]: s_a, s_b, inv_s_out, mask
  const float* vln = vecs + (RES ? 3 * cp : 0);
  const int lane = threadIdx.x & 31, l = lane & (g - 1);
  const int rows = kThreads / g;
  const int r_loc = (threadIdx.x >> 5) * (32 / g) + lane / g;
  // the lane's chunks of block blk (zeros past M and past the row)
  uint4 xa[K], xb[RES ? K : 1];
  auto load = [&](int blk) {
    const int m = blk * rows + r_loc;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = l + g * k;
      const bool in = m < M && j < nch;
      const size_t off = static_cast<size_t>(m) * cp + kChunk * j;
      xa[k] = in ? ld_stream(a + off) : make_uint4(0, 0, 0, 0);
      if (RES) xb[k] = in ? ld_stream(b + off) : make_uint4(0, 0, 0, 0);
    }
  };
  const int first = blockIdx.x;
  if (first < blocks) load(first);  // in flight while the vectors are staged
  // every mask an integer of magnitude ≤ 8; every ratio 1; every LN vector
  // finite, and m·x too (|m·x| ≤ 255·128·|mask|)
  int small = 1, unit = 1, finite = 1;
  for (int c = threadIdx.x; c < cp; c += kThreads) {
    const int at = (c >> 4) * kLd + (c & 15);
    const float mask = vln[c], w_os = vln[cp + c], b_os = vln[2 * cp + c], ratio = vln[3 * cp + c];
    cln[at] = make_float4(mask, w_os, b_os, ratio);
    if (RES) cres[at] = make_float4(vecs[c], vecs[cp + c], vecs[2 * cp + c], mask);
    small &= (mask == rintf(mask) && fabsf(mask) <= 8.f) ? 1 : 0;
    unit &= ratio == 1.f ? 1 : 0;
    finite &= (isfinite(__fmul_rn(mask, 32640.f)) && isfinite(w_os) && isfinite(b_os) && isfinite(ratio)) ? 1 : 0;
  }
  const bool fast = __syncthreads_and(small) != 0;
  const bool unit_ratio = __syncthreads_and(unit) != 0;
  const bool finite_cols = __syncthreads_and(finite) != 0;

  const float s1 = s1p[0], cf = static_cast<float>(c_true);

  for (int blk = first; blk < blocks; blk += gridDim.x) {
    const int m = blk * rows + r_loc;
    const bool row_in = m < M;
    const size_t row_off = static_cast<size_t>(m) * cp;
    uint4 code[K];  // the LN input codes of the lane's chunks
    FastSums fs;
    if (RES) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = l + g * k;
        code[k] = make_uint4(0, 0, 0, 0);
        if (j < nch) {
          const float4* cj = cres + j * kLd;
          uint32_t out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t wa = word(xa[k], q) ^ kFlip, wb = word(xb[k], q) ^ kFlip;
            uint32_t t[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 cr = cj[4 * q + e];
              const float val = __fadd_rn(__fmul_rn(code_f(wa, e), cr.x), __fmul_rn(code_f(wb, e), cr.y));
              const float tb = p2v::biased(__fmul_rn(val, cr.z), -128.f, 127.f);
              fs.add(__fmul_rn(p2v::unbias(tb), cr.w));
              t[e] = __float_as_uint(tb);
            }
            out[q] = pack4(t);
          }
          fs.end_chunk();
          code[k] = make_uint4(out[0], out[1], out[2], out[3]);
          if (row_in) st_stream(res_out + row_off + kChunk * j, code[k]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = l + g * k;
        code[k] = xa[k];
        if (j < nch) {
          const float4* cj = cln + j * kLd;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t w = word(code[k], q) ^ kFlip;
#pragma unroll
            for (int e = 0; e < 4; ++e) fs.add(__fmul_rn(code_f(w, e), cj[4 * q + e].x));
          }
          fs.end_chunk();
        }
      }
    }

    const int8_t* in_row = (RES ? res_out : a) + row_off;  // the LN input codes in memory
    long long sx = __float2int_rn(fs.sx), sxx = fs.sxx;
    if (!fast) {  // any mask: each x truncated to int64, as row_sums
      sx = sxx = 0;
      for (int k = 0; k < K && row_in; ++k) {
        const int j = l + g * k;
        if (j >= nch) break;
        for (int e = 0; e < kChunk; ++e) {
          const long long xi =
              static_cast<long long>(__fmul_rn(static_cast<float>(in_row[kChunk * j + e]), cln[j * kLd + e].x));
          sx += xi;
          sxx += xi * xi;
        }
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sxx += __shfl_xor_sync(0xffffffffu, sxx, o);
    }
    const p2v::LnRow lr = p2v::ln_row(__ll2float_rn(sx), __ll2float_rn(sxx), s1, cf);
    const bool odd = row_in && !(finite_cols && isfinite(lr.s1_over_std) && isfinite(lr.mean_over_std));
    if (__any_sync(0xffffffffu, odd))
      ln_pass_exact(in_row, cln, nch, l, g, K, lr, ln_out + row_off, row_in);
    else if (unit_ratio)
      ln_pass<K, true>(code, cln, nch, l, g, lr, ln_out + row_off, row_in);
    else
      ln_pass<K, false>(code, cln, nch, l, g, lr, ln_out + row_off, row_in);
    if (blk + static_cast<int>(gridDim.x) < blocks) load(blk + gridDim.x);
  }
}

// Exhaustive checks of ln_code_fast's two rewrites over every float32 bit
// pattern u: bad[0] counts the u = a whose p2n_bits powers differ from
// exp2i(±N) of ln_elem, bad[1] the u = z, not NaN, whose code_sat(z)
// differs from ln_code's byte of clip(rint(rint(z)·1)).
__global__ void ln_chain_check_kernel(unsigned long long* bad) {
  unsigned long long n_pow = 0, n_unit = 0;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       i < (1ull << 32); i += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float v = __uint_as_float(static_cast<uint32_t>(i));
    const int n = min(max(7 - p2v::floor_log2i(v), 0), 31);
    const uint32_t pb = p2n_bits(v);
    n_pow += (pb != __float_as_uint(p2v::exp2i(n)) || 0x7F000000u - pb != __float_as_uint(p2v::exp2i(-n))) ? 1 : 0;
    const uint32_t want = p2v::code_byte(p2v::biased(__fmul_rn(rintf(v), 1.f), -128.f, 127.f));
    n_unit += (v == v && (code_sat(v) & 0xFFu) != want) ? 1 : 0;
  }
  if (n_pow) atomicAdd(bad, n_pow);
  if (n_unit) atomicAdd(bad + 1, n_unit);
}

using KernelFn = void (*)(const int8_t*, const int8_t*, const float*, const float*, int8_t*, int8_t*, int, int,
                          int, int, int);

template <bool RES>
KernelFn pick(int k) {
  switch (k) {
    case 1: return int_ln_kernel<1, RES>;
    case 2: return int_ln_kernel<2, RES>;
    case 3: return int_ln_kernel<3, RES>;
    case 4: return int_ln_kernel<4, RES>;
    case 6: return int_ln_kernel<6, RES>;
    case 8: return int_ln_kernel<8, RES>;
    case 10: return int_ln_kernel<10, RES>;
    default: return nullptr;
  }
}

KernelFn kernel_of(int k, bool res) { return res ? pick<true>(k) : pick<false>(k); }

// The card's SMs and a kernel's resident CTAs per SM at `smem` bytes, cached
// per (kernel, smem): the occupancy call costs microseconds.
cudaError_t residency(KernelFn kern, int smem, int* sms, int* per_sm) {
  struct Entry {
    KernelFn kern;
    int dev, smem, sms, per_sm;
  };
  static Entry cache[64];
  static int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const Entry& e : cache)
    if (e.kern == kern && e.dev == dev && e.smem == smem) {
      *sms = e.sms, *per_sm = e.per_sm;
      return cudaSuccess;
    }
  Entry e{kern, dev, smem, 0, 0};
  err = p2v::set_smem(kern, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&e.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&e.per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (e.per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[next++ % 64] = e;
  *sms = e.sms, *per_sm = e.per_sm;
  return cudaSuccess;
}

// The plan and kernel at (M, cp); g > 0 forces the lanes per row.
cudaError_t plan_of(int M, int cp, bool res, int g, LnPlan* plan, KernelFn* kern) {
  if (cp < kChunk || cp % kChunk || (g != 0 && (g < 1 || g > 32 || (g & (g - 1))))) return cudaErrorInvalidValue;
  const LnPlan p = ln_plan(M, cp, res, 1, 1, g);
  *kern = kernel_of(p.k, res);
  if (*kern == nullptr) return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  const cudaError_t err = residency(*kern, p.smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  *plan = ln_plan(M, cp, res, sms, per_sm, g);
  return cudaSuccess;
}

int launch(const void* a, const void* b, const void* vecs, const void* s1, void* res_out, void* ln_out, int M, int cp,
           int c_true, bool res, int g, void* stream) {
  if (M == 0) return 0;
  if (c_true < 1 || c_true > cp) return static_cast<int>(cudaErrorInvalidValue);
  LnPlan p{};
  KernelFn kern = nullptr;
  const cudaError_t err = plan_of(M, cp, res, g, &p, &kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const float*>(vecs),
      static_cast<const float*>(s1), static_cast<int8_t*>(res_out), static_cast<int8_t*>(ln_out), M, cp, c_true, p.g,
      p.blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes (M, cp) → out (M, cp); vecs (4, cp); the LN counts c_true columns;
// g > 0 forces the lanes per row (a measurement hook; 0 takes the plan's).
extern "C" int p2v_int_ln_requant(const void* codes, const void* vecs, const void* s1, void* out, int M, int cp,
                                  int c_true, int g, void* stream) {
  return launch(codes, nullptr, vecs, s1, nullptr, out, M, cp, c_true, false, g, stream);
}

// a, b (M, cp) → res_out, ln_out (M, cp); vecs (7, cp).
extern "C" int p2v_int_res_ln_requant(const void* a, const void* b, const void* vecs, const void* s1, void* res_out,
                                      void* ln_out, int M, int cp, int c_true, int g, void* stream) {
  return launch(a, b, vecs, s1, res_out, ln_out, M, cp, c_true, true, g, stream);
}

// The launch facts at (M, cp): out = {g, k, rows per CTA block, blocks,
// grid, shared memory, registers, spill bytes, CTAs per SM, SMs}.
extern "C" int p2v_int_ln_info(int M, int cp, int res, int g, void* out) {
  LnPlan p{};
  KernelFn kern = nullptr;
  cudaError_t err = plan_of(M, cp, res != 0, g, &p, &kern);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = residency(kern, p.smem, &sms, &per_sm);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[10] = {p.g, p.k, p.rows, p.blocks, p.grid, p.smem, fa.numRegs,
                        static_cast<int>(fa.localSizeBytes), per_sm, sms};
  for (int i = 0; i < 10; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}

// ln_code_fast's rewrites checked over all 2^32 floats: bad (2 × uint64,
// zeroed) receives the mismatches of the powers and of the unit-ratio fold.
extern "C" int p2v_ln_chain_check(void* bad, void* stream) {
  ln_chain_check_kernel<<<1024, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}
