// Shared device code of the p2vit_tpu_torch kernels (sm_90a).
//
// * exact exponent-field math (floor_log2i / exp2i), as ops/fastmath.py;
// * the A&S 7.1.26 erf-GELU, as ops/matmul_int8.py gelu_as;
// * the serving integer-LN chain, as ops/intln.py ln_mn_chain;
// * the Log-Int-Softmax row chain of both attention kernels, as
//   ops/attention_lis.py lis_codes, and the LIS-off fp32 softmax row;
// * Gemm: a tiled int8 x int8 -> int32 matrix product on mma.sync.m16n8k32,
//   shared by the five GEMM kernels; its B operand comes from int8 rows or,
//   for the int4 kernel, from a nibble-packed store (PackedInt4Rows).
//
// Every float32 operation that a plain PyTorch version rounds on its own is
// written with an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), which the compiler never contracts into an FMA;
// the library is also built with --fmad=false. exp goes through float64 and
// is rounded once, as ops/fastmath.exp_rn. Rounding is rintf (half to even),
// never roundf. Together these make every kernel equal to its plain version
// bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace p2v {

constexpr int kThreads = 256;  // every kernel runs 8 warps per block

__device__ __forceinline__ int floor_log2i(float x) {
  return ((__float_as_int(x) >> 23) & 0xFF) - 127;
}

__device__ __forceinline__ float exp2i(int k) { return __int_as_float((k + 127) << 23); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ int8_t to_i8(float code) { return static_cast<int8_t>(static_cast<int>(code)); }

// clip(round(y)) onto [lo, hi], half to even
__device__ __forceinline__ float requant(float y, float lo, float hi) { return clampf(rintf(y), lo, hi); }

// erf by Abramowitz & Stegun 7.1.26; constants are the float32 roundings of
// the double literals, as PyTorch and JAX form them.
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = static_cast<float>(0.254829592), a2 = static_cast<float>(-0.284496736),
              a3 = static_cast<float>(1.421413741), a4 = static_cast<float>(-1.453152027),
              a5 = static_cast<float>(1.061405429), p = static_cast<float>(0.3275911);
  const float s = signf(x), ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float e = static_cast<float>(exp(static_cast<double>(__fmul_rn(-ax, ax))));
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, e)));
}

__device__ __forceinline__ float gelu_as(float y) {
  const float h = erf_as(__fmul_rn(y, static_cast<float>(0.7071067811865476)));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, h));
}

// Row constants of the integer LN chain from the exact row sums.
struct LnRow {
  float s1_over_std, mean_over_std;
};

__device__ __forceinline__ LnRow ln_row(float sx, float sxx, float s1, float c) {
  const float mean = __fmul_rn(__fdiv_rn(sx, c), s1);
  const float var_c = __fsub_rn(__fmul_rn(c, sxx), __fmul_rn(sx, sx));
  const float std_ = __fmul_rn(__fdiv_rn(s1, c), __fsqrt_rn(var_c));
  return {__fdiv_rn(s1, std_), __fdiv_rn(mean, std_)};
}

// y = round((sign(A)·M·x + B)·2^-N) for one element (ops/intln.ln_mn_chain)
__device__ __forceinline__ float ln_elem(const LnRow& row, float x, float w_os, float b_os) {
  const float a = __fmul_rn(row.s1_over_std, w_os);
  const float a_abs = fabsf(a);
  const int n = min(max(7 - floor_log2i(a_abs), 0), 31);
  const float p2n = exp2i(n);
  const float m = clampf(floorf(__fmul_rn(a_abs, p2n)), 0.f, 255.f);
  const float bb = rintf(__fmul_rn(__fsub_rn(b_os, __fmul_rn(row.mean_over_std, w_os)), p2n));
  return rintf(__fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(signf(a), m), x), bb), exp2i(-n)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// 16-byte global → shared copy that bypasses registers (cp.async, sm_80+)
__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sign-extend one nibble per byte (values 0..15 in the low half of each
// byte) into int8 codes: bit 3 set → high half 0xF. No byte carries into the
// next: 8·0x1E = 0xF0.
__device__ __forceinline__ uint32_t nib_sext(uint32_t x) { return x | ((x & 0x08080808u) * 0x1Eu); }

// Gemm B rows from an int4-packed store (ops/matmul_int8.pack_int4): byte j
// of row n holds code (n, j) in its low nibble and code (n, j + khalf) in its
// high nibble. khalf % 16 == 0 (the wrapper pads both halves), so a 16-code
// chunk [k, k + 16) lies wholly in one half: one 16-byte load of packed
// bytes, unpacked in registers to 16 int8 codes of the stage. Codes at
// k >= K, and rows past N, are zeros.
struct PackedInt4Rows {
  const int8_t* w;
  int n0, N, khalf;

  __device__ __forceinline__ void load16(int r, int k, int K, int8_t* dst) const {
    int4 out = make_int4(0, 0, 0, 0);
    if (n0 + r < N && k < K) {
      const bool hi = k >= khalf;
      const int4 v = __ldg(reinterpret_cast<const int4*>(w + (size_t)(n0 + r) * khalf + (hi ? k - khalf : k)));
      const int sh = hi ? 4 : 0;
      out.x = static_cast<int>(nib_sext((static_cast<uint32_t>(v.x) >> sh) & 0x0F0F0F0Fu));
      out.y = static_cast<int>(nib_sext((static_cast<uint32_t>(v.y) >> sh) & 0x0F0F0F0Fu));
      out.z = static_cast<int>(nib_sext((static_cast<uint32_t>(v.z) >> sh) & 0x0F0F0F0Fu));
      out.w = static_cast<int>(nib_sext((static_cast<uint32_t>(v.w) >> sh) & 0x0F0F0F0Fu));
    }
    *reinterpret_cast<int4*>(dst) = out;
  }
};

// acc[BM][BN] = A_tile · B_tileᵀ over K, both operands int8 with K contiguous.
// a_row(r) / b_row(r) return the global address of tile row r, or nullptr
// for a row outside the matrix (loaded as zeros), so callers can gather rows
// and mask edges without padding copies. K % 16 == 0 and 16-byte aligned
// rows are the caller's contract (the Python wrappers check them).
//
// 8 warps in a WM x WN grid; each warp owns a (BM/WM) x (BN/WN) sub-tile of
// m16n8k32 fragments. K is staged 64 bytes at a time through two shared
// buffers: cp.async fills slice k+1 while the tensor cores work on slice k.
// Smem rows are padded to 80 bytes so the fragment loads are free of bank
// conflicts. The int32 accumulation is exact, so staging never changes a bit.
//
// run_resident takes an A tile that already lies in shared memory (row r at
// sa + r·lda, K % 64 == 0) and stages only B; the fused layer feeds its
// MLP input and GELU tiles that way.
//
// b_row may instead be a PackedInt4Rows: B rows are then unpacked from the
// int4 store by plain loads into the stage (no cp.async); the stage is read
// only after the __syncthreads that follows the wait, as for the copies.
template <int BM, int BN, int WM, int WN>
struct Gemm {
  static constexpr int BK = 64;
  static constexpr int LDS = BK + 16;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int STAGE = (BM + BN) * LDS;
  static constexpr int SMEM_BYTES = 2 * STAGE;
  static_assert(WM * WN * 32 == kThreads, "Gemm runs 8 warps");
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile must be whole m16n8 fragments");

  // issue the copies of K slice [k0, k0 + BK) into one stage (B rows only
  // when A is resident)
  template <bool RESIDENT, class ARow, class BRow>
  __device__ static void load(ARow& a_row, BRow& b_row, int K, int k0, int8_t* stage) {
    for (int idx = threadIdx.x + (RESIDENT ? BM * 4 : 0); idx < (BM + BN) * 4; idx += kThreads) {
      const int r = idx >> 2, k = k0 + (idx & 3) * 16;
      int8_t* dst = stage + r * LDS + (idx & 3) * 16;
      const int8_t* p;
      if constexpr (std::is_same<BRow, PackedInt4Rows>::value) {
        if (r >= BM) {
          b_row.load16(r - BM, k, K, dst);
          continue;
        }
        p = a_row(r);
      } else {
        p = r < BM ? a_row(r) : b_row(r - BM);
      }
      if (p != nullptr && k < K)
        cp_async16(dst, p + k);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
    cp_async_commit();
  }

  template <class ARow, class BRow>
  __device__ static void run(ARow a_row, BRow b_row, int K, int8_t* smem, int (&acc)[MT][NT][4]) {
    run_impl<false>(a_row, nullptr, 0, b_row, K, smem, acc);
  }

  template <class BRow>
  __device__ static void run_resident(const int8_t* sa, int lda, BRow b_row, int K, int8_t* smem,
                                      int (&acc)[MT][NT][4]) {
    auto none = [](int) -> const int8_t* { return nullptr; };
    run_impl<true>(none, sa, lda, b_row, K, smem, acc);
  }

  template <bool RESIDENT, class ARow, class BRow>
  __device__ static void run_impl(ARow& a_row, const int8_t* sa, int lda, BRow& b_row, int K,
                                  int8_t* smem, int (&acc)[MT][NT][4]) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    const int nk = (K + BK - 1) / BK;
    const int ald = RESIDENT ? lda : LDS;
    load<RESIDENT>(a_row, b_row, K, 0, smem);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load<RESIDENT>(a_row, b_row, K, (kt + 1) * BK, smem + ((kt + 1) & 1) * STAGE);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* sA = RESIDENT ? sa + kt * BK : smem + (kt & 1) * STAGE;
      const int8_t* sB = smem + (kt & 1) * STAGE + BM * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int8_t* base = sA + (wm * WTM + i * 16 + g) * ald + kk + t * 4;
          a[i][0] = ld32(base);
          a[i][1] = ld32(base + 8 * ald);
          a[i][2] = ld32(base + 16);
          a[i][3] = ld32(base + 8 * ald + 16);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* base = sB + (wn * WTN + j * 8 + g) * LDS + kk + t * 4;
          b[j][0] = ld32(base);
          b[j][1] = ld32(base + 16);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }
  }

  // tile coordinates of acc[i][j][e] for the calling thread
  __device__ static int row_of(int i, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / WN) * WTM + i * 16 + (lane >> 2) + (e >> 1) * 8;
  }
  __device__ static int col_of(int j, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp % WN) * WTN + j * 8 + (lane & 3) * 2 + (e & 1);
  }
};

// Σ over the warp (integers: exact, so the order does not matter)
template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Log-Int-Softmax of one attention row held by a warp (ops/attention_lis.py
// lis_codes, op for op). Lane l holds the scores ac[t] of keys l + 32·t of a
// row of n keys (slots past n are ignored). Per key: the I-BERT int-exp on
// x = max(ac − rowmax, 32·x0) with the constants x0_int, b_int, c_int;
// exp_sum as an exact two-limb int64 sum (hi = ⌊e·2^-32⌋, lo = e − hi·2^32)
// rounded once to float32; the LIS code q = ⌊log2 round(Σ/e)⌋ + tie. Writes
// each key's weight as the integer 2^(15−q), 0 when q ≥ 16.
template <int JT>
__device__ __forceinline__ void lis_row(const float (&ac)[JT], int n, float x0, float b_int,
                                        float c_int, int (&wt)[JT]) {
  const int lane = threadIdx.x & 31;
  float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int t = 0; t < JT; ++t)
    if (lane + 32 * t < n) mx = fmaxf(mx, ac[t]);
  mx = warp_max(mx);

  const float xmin = __fmul_rn(32.f, x0);
  float ex[JT];
  long long shi = 0, slo = 0;
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    ex[t] = 0.f;
    if (lane + 32 * t < n) {
      const float xi = fmaxf(__fsub_rn(ac[t], mx), xmin);
      const float q = floorf(__fdiv_rn(xi, x0));
      const float rr = __fsub_rn(xi, __fmul_rn(x0, q));
      const float poly = __fadd_rn(__fmul_rn(rr, __fadd_rn(rr, b_int)), c_int);
      const float e = fmaxf(floorf(__fmul_rn(poly, exp2i(32 - static_cast<int>(q)))), 0.f);
      ex[t] = e;
      const float hf = floorf(__fmul_rn(e, 0x1p-32f));
      shi += static_cast<long long>(hf);
      slo += static_cast<long long>(__fsub_rn(e, __fmul_rn(hf, 0x1p32f)));
    }
  }
  shi = warp_sum(shi);
  slo = warp_sum(slo);
  shi += slo >> 32;
  slo &= 0xFFFFFFFFLL;
  const float esum = shi < (1LL << 31)
                         ? __ll2float_rn((shi << 32) + slo)
                         : __fmul_rn(__ll2float_rn((shi << 1) | (slo != 0 ? 1LL : 0LL)), 0x1p31f);
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    wt[t] = 0;
    if (lane + 32 * t < n) {
      const float so = rintf(__fdiv_rn(esum, ex[t]));
      int big = floor_log2i(so);
      big += so >= __fmul_rn(1.5f, exp2i(big)) ? 1 : 0;
      wt[t] = big < 16 ? (1 << (15 - big)) : 0;
    }
  }
}

// The LIS-off fp32 softmax of one attention row held by a warp
// (ops/attention_lis.py _attend with lis=False, op for op), in lis_row's lane
// layout. logit = code·s; e = exp(logit − rowmax) through float64, rounded
// once; the row sum S in float64, rounded once; p = e / S. Slots past n get
// p = 0. The float64 sum is exact while every term lies within ~2^20 of the
// row's largest (e ≤ 1, 24-bit mantissas, n ≤ 256); beyond that the order can
// change only the last float64 bit, which reaches S only on an exact float32
// rounding tie, so the butterfly order here needs no match in the plain version.
template <int JT>
__device__ __forceinline__ void softmax_row(const float (&ac)[JT], int n, float s, float (&p)[JT]) {
  const int lane = threadIdx.x & 31;
  float lg[JT];
  float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    lg[t] = __fmul_rn(ac[t], s);
    if (lane + 32 * t < n) mx = fmaxf(mx, lg[t]);
  }
  mx = warp_max(mx);
  double sum = 0.0;
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    p[t] = 0.f;
    if (lane + 32 * t < n) {
      p[t] = static_cast<float>(exp(static_cast<double>(__fsub_rn(lg[t], mx))));
      sum = __dadd_rn(sum, static_cast<double>(p[t]));
    }
  }
  const float S = __double2float_rn(warp_sum(sum));
#pragma unroll
  for (int t = 0; t < JT; ++t)
    if (lane + 32 * t < n) p[t] = __fdiv_rn(p[t], S);
}

// Launch helper: raise the dynamic shared-memory limit when a kernel needs
// more than the default 48 KB.
template <class Kernel>
inline cudaError_t set_smem(Kernel k, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace p2v
