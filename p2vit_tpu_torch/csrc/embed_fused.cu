// The serving prologue in one kernel (ops/embed_fused.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/embed_fused.py:fused_patch_embed.
// Output rows are the B·(NP+1) tokens. Row p = 0 of an image is [CLS] (the
// constant codes cls[c]); row p ≥ 1 is patch p−1:
//   mid1 = clip(round(acc·r1 + b1)); mid2 = clip(round(mid1·r2));
//   xc   = clip(round((mid2·s_embed + pos[p−1]) / s_qact1))
// then h = clip(round(LN(xc·mask))) with the block-0 LN1 constants. With
// float32 patches (the JAX kernel's other arm) the codes are first
// clip(round(x / s_input)).
//
// Bound on the H100: the bytes (patches in, two code tensors out; 5.9 µs
// at DeiT-S batch 64); the kernel is bound by its per-element epilogue and
// LN chain (~45 instructions an element), which the SMs must issue. The
// design, on gemm_wgmma.cuh's parts, is the junction kernel's
// (csrc/matmul_ln.cu):
// * the GEMM runs over the contiguous (B·NP, K) patch matrix, so a TMA box
//   of 64·NC patch rows needs no gather; patch row m is token row
//   m + ⌊m/NP⌋ + 1 of the outputs. The [CLS] rows are the same for every
//   image: an idle warp of each CTA's producer warpgroup computes the row
//   once (its sums over the whole row from the codes and mask in memory)
//   while the consumers run, and stores its columns for the images
//   b ≡ its cluster (mod clusters);
// * whole rows per cluster: a cluster of CS CTAs owns row blocks of 64·NC
//   patch rows, CTA r taking cpc chunks of BN columns; a producer thread
//   TMA-loads 64·NC patch rows and BN weight rows of 128 K bytes a ring
//   stage (128-byte swizzle, zeros past M, N and K) and the NC consumer
//   warpgroups run wgmma.m64nBNk32 on the same stage, so the weight panel
//   is read once per 64·NC rows (the mma.sync kernel read it per 32);
// * the epilogue runs on the accumulator registers after each chunk: the
//   codes go to a shared-memory code tile, Σx (int32) and Σx² (int64) to
//   registers, exact; the cluster adds its peers' row sums through
//   distributed shared memory; the six column vectors and the divisors'
//   reciprocals are staged in shared memory once per CTA; a chunk's
//   positional values (float2s from L2: a block's 64·NC rows of them would
//   not fit beside the ring and the code tile) are loaded into registers
//   before its products, so their latency hides under them (BN ≤ 192);
// * the PTF divide is correctly rounded: with y = RN(1/d) staged per
//   column, q = RN(val·y), r = val − q·d (exact, fma) and RN(q + r·y) is
//   RN(val/d) (Markstein); where |q| ≥ 1024 the code saturates either way,
//   so q itself is taken. Used where every divisor of the CTA lies in
//   [2^-64, 2^64], else __fdiv_rn; checked against __fdiv_rn over all 2^32
//   dividends on the card (p2v_embed_div_check);
// * then the LN pass over the tile: lanes own 16-column chunks (their
//   vectors in registers) and walk the warp's rows, both outputs stored as
//   16-byte words; the LN chain is ln_code_fast (ln_chain.cuh), and a row
//   whose constants are not finite (0/0) takes ln_code_exact;
// * the float32 arm has no TMA for the patches: each consumer converts its
//   own 64 rows of a stage (16 codes a thread at a time, the true divide)
//   and writes them in the 128-byte swizzle the wgmma descriptors read.
// The wrapper zero-pads K to 16 and C to 16 (embed_pad); the LN counts the
// true width c_true. embed_plan (whole_row_plan) picks CS, BN, cpc and NC
// (ops/embed_fused.embed_plan mirrors it).
#include "gemm_wgmma.cuh"
#include "ln_chain.cuh"

namespace p2v {
namespace wg {

constexpr int kEmbedMaxConsumers = kRowMaxConsumers;
constexpr int kEmbedMaxCluster = kRowMaxCluster;
// The chunk widths: kWidths' but 256, whose accumulators leave no room for a
// chunk's positional values (loaded before its products).
constexpr int kEmbedWidths[] = {192, 144, 128, 96};

// Shared memory: 1024 B of alignment slack, the ring ((64·NC + BN)·128 B a
// stage), NC code tiles of 64 rows over the CTA's cpc chunks, seven vectors
// over them (r1, b1, s_qact1, mask, w_os, b_os and 1/s_qact1), the row
// constants (8 B a row), a full and an empty barrier per stage and, in
// clusters, two row-sum barriers and two buffers of the rows' partial sums.
inline int embed_smem(int bn, int cpc, int nc, int stages, int cs) {
  const int nw = bn * cpc;
  return 1024 + stages * (kBM * nc + bn) * kBK + nc * kBM * code_ld(nw) + 7 * nw * 4 + nc * kBM * 8 +
         16 * stages + (cs > 1 ? 16 + 2 * nc * kBM * 16 : 0);
}

// The launch plan at M = B·NP patch rows and the padded width N: the
// junction kernel's rule (whole_row_plan, gemm_wgmma.cuh) over embed_smem
// and kEmbedWidths.
inline RowPlan embed_plan(int M, int N, const int* resident, int force_cs = 0, int force_nc = 0) {
  return whole_row_plan(M, N, kEmbedWidths, 4, embed_smem, resident, force_cs, force_nc);
}

// Where every divisor d of a CTA satisfies this, its PTF divide takes
// div_markstein: far from underflow and overflow for every quotient whose
// code depends on its last bit (|val/d| < 1024).
__device__ __forceinline__ bool markstein_ok(float d) {
  const float a = fabsf(d);
  return a >= 0x1p-64f && a <= 0x1p64f;
}

// RN(a/d) for |a/d| < 1024, given y = RN(1/d): q = RN(a·y) lies within two
// ulps of a/d, r = a − q·d is exact, and RN(q + r·y) = RN(a/d) (Markstein's
// correction). Past |q| ≥ 1024 (and for an infinite or NaN a) q itself:
// the code saturates at the same end.
__device__ __forceinline__ float div_markstein(float a, float d, float y) {
  const float q = __fmul_rn(a, y);
  const float r = __fmaf_rn(-q, d, a);
  const float qq = __fmaf_rn(r, y, q);
  return fabsf(q) < 1024.f ? qq : q;
}

// The code chain of one patch element (biased, matmul_tiles.cuh).
template <bool FASTDIV>
__device__ __forceinline__ float embed_code(int acc, float r1, float b1, float r2, float s_embed, float pos,
                                            float d, float y) {
  const float mid1 = rint_clipf(__fadd_rn(__fmul_rn(__int2float_rn(acc), r1), b1), -128.f, 127.f);
  const float mid2 = rint_clipf(__fmul_rn(mid1, r2), -128.f, 127.f);
  const float val = __fadd_rn(__fmul_rn(mid2, s_embed), pos);
  return biased(FASTDIV ? div_markstein(val, d, y) : __fdiv_rn(val, d), -128.f, 127.f);
}

// The positional values of CTA column col of a row (null past M; zeros past
// the CTA's columns).
__device__ __forceinline__ float2 pos_of(const float* prow, int col, int ncols) {
  return (prow != nullptr && col < ncols) ? __ldg(reinterpret_cast<const float2*>(prow + col)) : make_float2(0.f, 0.f);
}

// One chunk's epilogue on its accumulators: thread (w, l) holds
// acc[4j + 2h + e] at row g + 8h of its warp's rows (g = l/4), CTA column
// n0 + 8j + 2q + e (q = l%4). Codes into the tile, x = code·mask into the
// row sums; pv[j][h]: the positional values of the thread's two columns of
// group j in row g + 8h, loaded before the chunk's products.
template <int BN, bool FASTDIV>
__device__ __forceinline__ void embed_chunk(const int (&acc)[BN / 2], int8_t* ct, int ldc, int n0, const float* vs,
                                            int nw, const float2 (&pv)[BN / 8][2], int g, int q, float r2,
                                            float s_embed, int (&sx)[2], long long (&sxx)[2]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    const float2 r1 = *reinterpret_cast<const float2*>(vs + col);
    const float2 b1 = *reinterpret_cast<const float2*>(vs + nw + col);
    const float2 d = *reinterpret_cast<const float2*>(vs + 2 * nw + col);
    const float2 mk = *reinterpret_cast<const float2*>(vs + 3 * nw + col);
    const float2 y = *reinterpret_cast<const float2*>(vs + 6 * nw + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = pv[j][h];
      const float t0 = embed_code<FASTDIV>(acc[4 * j + 2 * h], r1.x, b1.x, r2, s_embed, p.x, d.x, y.x);
      const float t1 = embed_code<FASTDIV>(acc[4 * j + 2 * h + 1], r1.y, b1.y, r2, s_embed, p.y, d.y, y.y);
      *reinterpret_cast<uint16_t*>(ct + (g + 8 * h) * ldc + col) =
          static_cast<uint16_t>(code_byte(t0) | (code_byte(t1) << 8));
      const int x0 = __float2int_rz(__fmul_rn(unbias(t0), mk.x)), x1 = __float2int_rz(__fmul_rn(unbias(t1), mk.y));
      sx[h] += x0 + x1;
      sxx[h] += static_cast<long long>(x0) * x0;
      sxx[h] += static_cast<long long>(x1) * x1;
    }
  }
}

// The float32 arm's loader: consumer rows [m0, m0 + 64) of K slice k0 as
// int8 codes clip(round(x / s_in)) into the stage's 64 × 128-byte tile,
// 16-byte chunk c of row r at chunk c ^ (r % 8) (the TMA's 128-byte
// swizzle); zeros past M and K.
__device__ __forceinline__ void load_f32_rows(const float* pxf, float s_in, int M, int K, int m0, int k0,
                                              uint8_t* tile, int t128) {
#pragma unroll 1
  for (int i = t128; i < kBM * kBK / 16; i += 128) {
    const int r = i >> 3, c16 = i & 7, m = m0 + r, k = k0 + 16 * c16;
    uint32_t out[4] = {0, 0, 0, 0};
    if (m < M && k < K) {
      const float4* src = reinterpret_cast<const float4*>(pxf + (size_t)m * K + k);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 x = __ldg(src + v);
        const uint32_t t[4] = {code_of(__fdiv_rn(x.x, s_in)), code_of(__fdiv_rn(x.y, s_in)),
                               code_of(__fdiv_rn(x.z, s_in)), code_of(__fdiv_rn(x.w, s_in))};
        out[v] = pack4(t);
      }
    }
    *reinterpret_cast<uint4*>(tile + r * kBK + ((c16 ^ (r & 7)) << 4)) = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// The [CLS] rows, by an idle warp of the producer warpgroup of each CTA
// (rolled loops: the warp holds few registers): the row's exact sums over
// its whole width from cls and mask in memory, then h over the CTA's
// columns, stored with cls itself for the images b ≡ cl (mod ncl).
__device__ __forceinline__ void cls_rows(const int8_t* cls, const float* vecs, const float* vs, int nw, int N,
                                         int n0, int ncols, float s1, float cf, bool finite_cols, int NP, int B, int cl,
                                         int ncl, int8_t* xc_out, int8_t* h_out, int lane) {
  long long sx = 0, sxx = 0;
#pragma unroll 1
  for (int col = 16 * lane; col < N; col += 512) {  // 16 columns a lane
    const uint4 c4 = *reinterpret_cast<const uint4*>(cls + col);
#pragma unroll 1
    for (int e = 0; e < 16; ++e) {
      const long long xi =
          static_cast<long long>(__fmul_rn(code_f(word(c4, e / 4) ^ kFlip, e % 4), __ldg(vecs + 3 * N + col + e)));
      sx += xi;
      sxx += xi * xi;
    }
  }
  const LnRow lr = ln_row(__ll2float_rn(warp_sum(sx)), __ll2float_rn(warp_sum(sxx)), s1, cf);
  const bool ok = finite_cols && isfinite(lr.s1_over_std) && isfinite(lr.mean_over_std);
#pragma unroll 1
  for (int col = 16 * lane; col < ncols; col += 512) {
    const uint4 c4 = *reinterpret_cast<const uint4*>(cls + n0 + col);
    uint32_t out[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {  // each word's four codes packed by shifts: no local array
      out[v] = 0;
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        const int c = col + 4 * v + e;
        const float x = __fmul_rn(code_f(word(c4, v) ^ kFlip, e), vs[3 * nw + c]);
        const uint32_t t = ok ? ln_code_fast<true>(lr, x, vs[4 * nw + c], vs[5 * nw + c], 1.f)
                              : ln_code_exact(lr, x, vs[4 * nw + c], vs[5 * nw + c]);
        out[v] |= (t & 0xFFu) << (8 * e);
      }
    }
#pragma unroll 1
    for (int b = cl; b < B; b += ncl) {
      const size_t o = (size_t)b * (NP + 1) * N + n0 + col;
      *reinterpret_cast<uint4*>(xc_out + o) = c4;
      *reinterpret_cast<uint4*>(h_out + o) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// vecs rows: r1, b1, s_qact1, mask, w_os, b_os (each N, zero past n_true but
// s_qact1, one); scal: r2, s_embed, s1; pxf, s_in: the float32 arm's patches
// (B·NP, K) and s_input (pxf null: int8 patches through tmx). Launched in
// clusters of cs CTAs. stamps, if not null: the %globaltimer (ns) of the
// middle cluster's first CTA, consumer 0, at its start, after each chunk's
// products and epilogue of its first row block (1 + 2·ch, 2 + 2·ch;
// ch < 6), after the row constants (13) and the LN pass (14) of that
// block, and at its end (15).
template <int BN>
__global__ void __launch_bounds__(threads_of(kEmbedMaxConsumers), 1)
    embed_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const float* __restrict__ pxf, const float* __restrict__ s_in, const float* __restrict__ vecs,
                 const float* __restrict__ scal, const float* __restrict__ pos, const int8_t* __restrict__ cls,
                 int8_t* __restrict__ xc_out, int8_t* __restrict__ h_out, int B, int NP, int N, int n_true, int K,
                 int cpc, int cs, int nc, int stages, long long* __restrict__ stamps) {
  const int M = B * NP;
  const int nw = cpc * BN, ldc = code_ld(nw);
  const int rows = kBM * nc, stage_bytes = (rows + BN) * kBK;
  const bool f32 = pxf != nullptr;
  const uint32_t rank = cs > 1 ? cluster_rank() : 0;
  const int n0 = static_cast<int>(rank) * nw;  // the CTA's first column
  const int ncols = max(0, min(nw, N - n0));   // its columns inside N
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* codes = reinterpret_cast<int8_t*>(smem + stages * stage_bytes);  // [64·nc][ldc]
  float* vs = reinterpret_cast<float*>(codes + rows * ldc);                // [7][nw]
  float2* lnrows = reinterpret_cast<float2*>(vs + 7 * nw);                 // [64·nc] row constants
  uint64_t* full = reinterpret_cast<uint64_t*>(lnrows + rows);
  uint64_t* empty = full + stages;
  uint64_t* sums = empty + stages;                       // cs > 1, [2]: the peers' sums of a block landed
  RowSums* part = reinterpret_cast<RowSums*>(sums + 2);  // cs > 1, [2][64·nc] partial row sums

  const int nk = (K + kBK - 1) / kBK;
  // the vectors over the CTA's columns (s_qact1 one past N); every divisor
  // fit for div_markstein; every LN vector finite, and m·x too
  int fast = 1, finite = 1;
  for (int col = threadIdx.x; col < nw; col += blockDim.x) {
    const bool in = col < ncols;
    float v6[6];
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      v6[v] = in ? vecs[(size_t)v * N + n0 + col] : (v == 2 ? 1.f : 0.f);
      vs[v * nw + col] = v6[v];
    }
    vs[6 * nw + col] = __frcp_rn(v6[2]);
    fast &= markstein_ok(v6[2]) ? 1 : 0;
    finite &= (isfinite(__fmul_rn(v6[3], 32640.f)) && isfinite(v6[4]) && isfinite(v6[5])) ? 1 : 0;
  }
  const bool fastdiv = __syncthreads_and(fast) != 0;
  const bool finite_cols = __syncthreads_and(finite) != 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, nc);
    }
    if (cs > 1) {  // every peer's consumer lanes that hold row sums arrive
      mbar_init(sums, (cs - 1) * 4 * nc * 8);
      mbar_init(sums + 1, (cs - 1) * 4 * nc * 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (cs > 1)
    cluster_sync();  // the peers' barriers are initialized before any arrive
  else
    __syncthreads();
  const int cl = blockIdx.x / cs, ncl = gridDim.x / cs;  // this cluster, the clusters

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs<kEmbedMaxConsumers>::kProducer));
    if (threadIdx.x >> 5 == 1 && cl < B)  // warp 1: the [CLS] rows beside the consumers' first row block
      cls_rows(cls, vecs, vs, nw, N, n0, ncols, scal[2], static_cast<float>(n_true), finite_cols, NP, B, cl, ncl,
               xc_out, h_out, threadIdx.x & 31);
    if (threadIdx.x == 0) {
      if (!f32) asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmw)) : "memory");
      const int tx = f32 ? BN * kBK : stage_bytes;  // the float32 arm's consumers write the patch rows
      int st = 0, ph = 0;
      for (unsigned m0 = cl * rows; m0 < static_cast<unsigned>(M); m0 += ncl * rows)
        for (int ch = 0; ch < cpc; ++ch)
          for (int s = 0; s < nk; ++s) {
            mbar_wait(empty + st, ph ^ 1);
            mbar_expect_tx(full + st, tx);
            if (!f32) tma_load_2d(smem + st * stage_bytes, &tmx, s * kBK, static_cast<int>(m0), full + st);
            tma_load_2d(smem + st * stage_bytes + rows * kBK, &tmw, s * kBK, n0 + ch * BN, full + st);
            if (++st == stages) st = 0, ph ^= 1;
          }
    }
  } else {
    // ---- consumers: each owns 64 rows of the cluster's block ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs<kEmbedMaxConsumers>::kConsumer));
    const int c = (threadIdx.x >> 7) - 1, t128 = threadIdx.x & 127, w = t128 >> 5, lane = t128 & 31;
    const int g = lane >> 2, q = lane & 3;
    int8_t* ct = codes + (c * kBM + 16 * w) * ldc;  // the warp's 16 rows
    float2* lr = lnrows + c * kBM + 16 * w;
    const float r2 = scal[0], s_embed = scal[1], s1 = scal[2], cf = static_cast<float>(n_true);
    const float s_input = f32 ? s_in[0] : 1.f;
    const float *mask = vs + 3 * nw, *w_os = vs + 4 * nw, *b_os = vs + 5 * nw;
    const int n16 = ncols / 16;
    const int rstep = n16 >= 32 ? 1 : 32 / max(n16, 1);  // the LN pass's rows at a time
    const int c16_0 = n16 >= 32 ? lane : lane % max(n16, 1), rr_0 = n16 >= 32 ? 0 : lane / max(n16, 1);
    const bool stamper = stamps != nullptr && cl == ncl / 2 && rank == 0 && c == 0 && t128 == 0;
    auto stamp = [&](int i) {
      if (stamper) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(stamps[i])::"memory");
    };
    stamp(0);
    int st = 0, ph = 0, prev = 0;  // ring stage, its parity, the stage before it
    int it = 0;                    // the CTA's row blocks so far
    for (unsigned m0 = cl * rows; m0 < static_cast<unsigned>(M); m0 += ncl * rows, ++it) {
      const int r0 = static_cast<int>(m0) + c * kBM + 16 * w;  // the warp's first patch row
      const float* prow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + g + 8 * h;
        prow[h] = m < M ? pos + (size_t)(m % NP) * N + n0 : nullptr;
      }
      int sx[2] = {0, 0};
      long long sxx[2] = {0, 0};
      for (int ch = 0; ch < cpc; ++ch) {
        int acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        // the chunk's positional values, in flight while its products run
        float2 pv[BN / 8][2];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) pv[j][h] = pos_of(prow[h], ch * BN + 8 * j + 2 * q, ncols);
        for (int s = 0; s < nk; ++s) {
          mbar_wait(full + st, ph);
          uint8_t* stage = smem + st * stage_bytes;
          if (f32) {  // this consumer's rows, then visible to the async proxy
            load_f32_rows(pxf, s_input, M, K, static_cast<int>(m0) + c * kBM, s * kBK, stage + c * kBM * kBK, t128);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            named_sync(1 + c, 128);
          }
          const uint32_t a = smem_u32(stage);
          const uint64_t da = sw128_desc(a + c * kBM * kBK), db = sw128_desc(a + rows * kBK);
          const int ksteps = (min(kBK, K - s * kBK) + 31) / 32;
          wgmma_fence();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk)
            if (kk < ksteps) wgmma_s8(acc, da + 2 * kk, db + 2 * kk, s + kk);
          wgmma_commit();
          fence_regs(acc);
          if (s > 0) {
            wgmma_wait<1>();
            if (t128 == 0) mbar_arrive(empty + prev);
          }
          prev = st;
          if (++st == stages) st = 0, ph ^= 1;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (t128 == 0) mbar_arrive(empty + prev);
        if (it == 0 && ch < 6) stamp(1 + 2 * ch);
        if (fastdiv)
          embed_chunk<BN, true>(acc, ct, ldc, ch * BN, vs, nw, pv, g, q, r2, s_embed, sx, sxx);
        else
          embed_chunk<BN, false>(acc, ct, ldc, ch * BN, vs, nw, pv, g, q, r2, s_embed, sx, sxx);
        if (it == 0 && ch < 6) stamp(2 + 2 * ch);
      }
      // the row sums over the quad that holds each row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 1);
        sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 2);
        sxx[h] += __shfl_xor_sync(0xffffffffu, sxx[h], 1);
        sxx[h] += __shfl_xor_sync(0xffffffffu, sxx[h], 2);
      }
      if (cs > 1) {  // the peers' partial sums of the same rows, as the junction kernel adds them
        RowSums* mine = part + (it & 1) * rows + c * kBM + 16 * w;
        if (q == 0) {
          mine[g] = RowSums{sxx[0], sx[0], 0};
          mine[g + 8] = RowSums{sxx[1], sx[1], 0};
          for (int p = 0; p < cs; ++p)
            if (p != static_cast<int>(rank)) mbar_arrive_peer(sums + (it & 1), p);
        }
        mbar_wait_cluster(sums + (it & 1), (it >> 1) & 1);
        if (q == 0)
          for (int p = 0; p < cs; ++p)
            if (p != static_cast<int>(rank)) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const RowSums v = ld_peer(mine + g + 8 * h, p);
                sx[h] += v.sx;
                sxx[h] += v.sxx;
              }
            }
      }
      if (q == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const LnRow row = ln_row_exact(sx[h], sxx[h], s1, cf);
          lr[g + 8 * h] = make_float2(row.s1_over_std, row.mean_over_std);
        }
      __syncwarp();  // codes and row constants visible to the warp
      if (it == 0) stamp(13);
      // the LN pass: a lane owns a 16-column chunk (its vectors in
      // registers) and walks the warp's rows, 32/n16 rows at a time where a
      // row has fewer than 32 chunks; xc (the tile's codes) and h go out as
      // 16-byte words at token row m + ⌊m/NP⌋ + 1
      const int nrows = min(16, M - r0);
      if (lane < rstep * min(n16, 32))
        for (int c16 = c16_0; c16 < n16; c16 += 32) {
          const int col = 16 * c16;
          float mk[16], wo[16], bo[16];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 m4 = *reinterpret_cast<const float4*>(mask + col + 4 * v);
            const float4 w4 = *reinterpret_cast<const float4*>(w_os + col + 4 * v);
            const float4 b4 = *reinterpret_cast<const float4*>(b_os + col + 4 * v);
            mk[4 * v] = m4.x, mk[4 * v + 1] = m4.y, mk[4 * v + 2] = m4.z, mk[4 * v + 3] = m4.w;
            wo[4 * v] = w4.x, wo[4 * v + 1] = w4.y, wo[4 * v + 2] = w4.z, wo[4 * v + 3] = w4.w;
            bo[4 * v] = b4.x, bo[4 * v + 1] = b4.y, bo[4 * v + 2] = b4.z, bo[4 * v + 3] = b4.w;
          }
#pragma unroll 2
          for (int rr = rr_0; rr < nrows; rr += rstep) {
            const int m = r0 + rr;
            const uint4 code4 = *reinterpret_cast<const uint4*>(ct + rr * ldc + col);
            const float2 lv = lr[rr];
            const LnRow row{lv.x, lv.y};
            uint32_t out[4];
            if (finite_cols && isfinite(lv.x) && isfinite(lv.y)) {
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const uint32_t wv = word(code4, v) ^ kFlip;
                uint32_t t[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  t[e] = ln_code_fast<true>(row, __fmul_rn(code_f(wv, e), mk[4 * v + e]), wo[4 * v + e],
                                            bo[4 * v + e], 1.f);
                out[v] = pack4(t);
              }
            } else {  // 0/0: the exact chain and the plain version's NaN cast
              for (int v = 0; v < 4; ++v) {
                const uint32_t wv = word(code4, v) ^ kFlip;
                uint32_t t[4];
                for (int e = 0; e < 4; ++e)
                  t[e] = ln_code_exact(row, __fmul_rn(code_f(wv, e), mask[col + 4 * v + e]),
                                       w_os[col + 4 * v + e], b_os[col + 4 * v + e]);
                out[v] = pack4(t);
              }
            }
            const size_t o = (size_t)(m + m / NP + 1) * N + n0 + col;
            *reinterpret_cast<uint4*>(xc_out + o) = code4;
            *reinterpret_cast<uint4*>(h_out + o) = make_uint4(out[0], out[1], out[2], out[3]);
          }
        }
      __syncwarp();  // the tile rows are read before the next block's codes
      if (it == 0) stamp(14);
    }
    stamp(15);
  }
  if (cs > 1) cluster_sync();  // no CTA leaves while a peer may read its row sums
}

// Exhaustive check of div_markstein against __fdiv_rn: for each divisor
// d[i] (markstein_ok), every float32 dividend a; bad[0] counts the a with
// 1/4 ≤ |RN(a·y)| < 1024 (where a code can depend on the quotient's last
// bit) whose quotient bits differ, bad[1] the a whose int8 codes
// clip(round(·)) differ.
__global__ void embed_div_check_kernel(const float* d, int n, unsigned long long* bad) {
  unsigned long long n_bits = 0, n_code = 0;
  for (int i = 0; i < n; ++i) {
    const float di = d[i], y = __frcp_rn(di);
    for (unsigned long long u = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
         u < (1ull << 32); u += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
      const float a = __uint_as_float(static_cast<uint32_t>(u));
      const float want = __fdiv_rn(a, di), got = div_markstein(a, di, y);
      const float aq = fabsf(__fmul_rn(a, y));
      n_bits += (aq >= 0.25f && aq < 1024.f && __float_as_uint(want) != __float_as_uint(got)) ? 1 : 0;
      n_code += code_byte(biased(want, -128.f, 127.f)) != code_byte(biased(got, -128.f, 127.f)) ? 1 : 0;
    }
  }
  if (n_bits) atomicAdd(bad, n_bits);
  if (n_code) atomicAdd(bad + 1, n_code);
}

}  // namespace wg
}  // namespace p2v

namespace {

using EmbedKernel = void (*)(CUtensorMap, CUtensorMap, const float*, const float*, const float*, const float*,
                             const float*, const int8_t*, int8_t*, int8_t*, int, int, int, int, int, int, int, int,
                             int, long long*);

// The built instances: every width of p2v::wg::kEmbedWidths.
struct Instance {
  int bn;
  EmbedKernel kern;
  bool ready;
};

Instance g_instances[] = {{192, p2v::wg::embed_kernel<192>, false}, {144, p2v::wg::embed_kernel<144>, false},
                          {128, p2v::wg::embed_kernel<128>, false}, {96, p2v::wg::embed_kernel<96>, false}};

Instance* find_instance(int bn) {
  for (Instance& in : g_instances)
    if (in.bn == bn) return &in;
  return nullptr;
}

// The instance of the plan's width, its shared-memory limit raised and its
// register count checked on first use (the setmaxnreg hand-over assumes the
// launch's registers).
cudaError_t ready(Instance* in) {
  if (in == nullptr) return cudaErrorInvalidValue;
  if (in->ready) return cudaSuccess;
  cudaFuncAttributes attr{};
  cudaError_t err = p2v::set_smem(in->kern, p2v::wg::kMaxSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, in->kern);
  if (err == cudaSuccess && attr.numRegs != p2v::wg::Regs<p2v::wg::kEmbedMaxConsumers>::kLaunch)
    err = cudaErrorInvalidConfiguration;
  in->ready = err == cudaSuccess;
  return err;
}

cudaLaunchConfig_t launch_config(int grid, int cs, int nc, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(p2v::wg::threads_of(nc));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of 1 to 4 CTAs the card holds at once, for a CTA that fills
// shared memory (cached per device).
cudaError_t resident_clusters(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int cache[64][p2v::wg::kEmbedMaxCluster] = {};
  if (dev < 64 && cache[dev][0]) {
    for (int i = 0; i < p2v::wg::kEmbedMaxCluster; ++i) out[i] = cache[dev][i];
    return cudaSuccess;
  }
  Instance* in = find_instance(96);
  err = ready(in);
  for (int cs = 1; cs <= p2v::wg::kEmbedMaxCluster && err == cudaSuccess; ++cs) {
    cudaLaunchAttribute attr{};
    const cudaLaunchConfig_t cfg =
        launch_config(cs, cs, p2v::wg::kEmbedMaxConsumers, p2v::wg::kMaxSmem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&out[cs - 1], in->kern, &cfg);
  }
  if (err == cudaSuccess && dev < 64)
    for (int i = 0; i < p2v::wg::kEmbedMaxCluster; ++i) cache[dev][i] = out[i];
  return err;
}

}  // namespace

// patches (B·NP, K) int8, or pxf (B·NP, K) float32 with s_in (1,) and
// patches null; w (N, K) int8; K % 16 == 0, N % 16 == 0, all 16-byte
// aligned (the wrapper pads and checks); vecs (6, N), scal (3,), pos
// (NP, N) float32, cls (N,) int8; xc_out, h_out (B, NP + 1, N) int8. The LN
// counts c_true. force_cs, force_nc: 0, or the plan's cluster size and
// consumers (a measurement hook; cudaErrorInvalidConfiguration where that
// does not fit); stamps: null, or 16 int64 of the phase clock
// (embed_kernel).
extern "C" int p2v_fused_patch_embed_forced(const void* patches, const void* pxf, const void* s_in, const void* w,
                                            const void* vecs, const void* scal, const void* pos, const void* cls,
                                            void* xc_out, void* h_out, int B, int NP, int K, int C, int c_true,
                                            int force_cs, int force_nc, void* stamps, void* stream) {
  if (B == 0) return 0;
  if (C % 16 || K % 16 || c_true < 1 || c_true > C || NP < 1 || (patches == nullptr) == (pxf == nullptr) ||
      (long long)B * NP >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident[p2v::wg::kEmbedMaxCluster];
  cudaError_t err = resident_clusters(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * NP;
  const p2v::wg::RowPlan plan = p2v::wg::embed_plan(M, C, resident, force_cs, force_nc);
  if (plan.nc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Instance* in = find_instance(plan.bn);
  err = ready(in);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tmx{}, tmw{};
  if ((patches != nullptr && !p2v::wg::tensor_map(&tmx, patches, M, K, p2v::wg::kBM * plan.nc)) ||
      !p2v::wg::tensor_map(&tmw, w, C, K, plan.bn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr{};
  const cudaLaunchConfig_t cfg =
      launch_config(plan.grid, plan.cs, plan.nc, plan.smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, in->kern, tmx, tmw, static_cast<const float*>(pxf), static_cast<const float*>(s_in),
                           static_cast<const float*>(vecs), static_cast<const float*>(scal),
                           static_cast<const float*>(pos), static_cast<const int8_t*>(cls),
                           static_cast<int8_t*>(xc_out), static_cast<int8_t*>(h_out), B, NP, C, c_true, K, plan.cpc,
                           plan.cs, plan.nc, plan.stages, static_cast<long long*>(stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2v_fused_patch_embed(const void* patches, const void* pxf, const void* s_in, const void* w,
                                     const void* vecs, const void* scal, const void* pos, const void* cls,
                                     void* xc_out, void* h_out, int B, int NP, int K, int C, int c_true,
                                     void* stream) {
  return p2v_fused_patch_embed_forced(patches, pxf, s_in, w, vecs, scal, pos, cls, xc_out, h_out, B, NP, K, C, c_true,
                                      0, 0, nullptr, stream);
}

// The launch facts at M = B·NP patch rows, padded width C (force_cs,
// force_nc as above): out[0..16] = BN, chunks per CTA, CTAs per cluster,
// consumer warpgroups, stages, row blocks, grid, dynamic shared memory,
// registers per thread at launch, spill bytes per thread, a consumer's
// registers after setmaxnreg, CTAs per SM, SMs, and the clusters of 1, 2, 3
// and 4 CTAs the card holds at once.
extern "C" int p2v_fused_patch_embed_info(int M, int C, int force_cs, int force_nc, void* out) {
  int resident[p2v::wg::kEmbedMaxCluster];
  cudaError_t err = resident_clusters(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const p2v::wg::RowPlan plan = p2v::wg::embed_plan(M, C, resident, force_cs, force_nc);
  if (plan.nc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Instance* in = find_instance(plan.bn);
  err = ready(in);
  cudaFuncAttributes attr{};
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, in->kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in->kern, p2v::wg::threads_of(plan.nc), plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[17] = {plan.bn,
                        plan.cpc,
                        plan.cs,
                        plan.nc,
                        plan.stages,
                        plan.blocks,
                        plan.grid,
                        plan.smem,
                        attr.numRegs,
                        static_cast<int>(attr.localSizeBytes),
                        p2v::wg::Regs<p2v::wg::kEmbedMaxConsumers>::kConsumer,
                        per_sm,
                        p2v::wg::sm_count(),
                        resident[0],
                        resident[1],
                        resident[2],
                        resident[3]};
  for (int i = 0; i < 17; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}

// div_markstein against __fdiv_rn over all 2^32 dividends for each of the n
// divisors d (float32 on the card, each within [2^-64, 2^64]): bad (2 ×
// uint64, zeroed) receives the quotient-bit and the code mismatches.
extern "C" int p2v_embed_div_check(const void* d, int n, void* bad, void* stream) {
  p2v::wg::embed_div_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), n, static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}
