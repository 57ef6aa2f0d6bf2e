// Windowed int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax,
// for Swin (ops/attention_lis.py swin_lis_attention).
//
// Replaces the Pallas kernel p2vit_tpu/ops/attention_lis.py:swin_lis_attention
// (_swin_kernel -> _swin_head_loop). One block per (window, head), head_dim
// D = 32, N ≤ 64 tokens per window (49 for 7×7 windows), no padding: rows and
// keys past N are never read, so nothing has to be parked out of the row max
// or the sum.
//
// 1. The head's q, k, v rows (N × 32 bytes each) are copied from the
//    (W, N, 3C) qkv codes into shared memory, rows of 36 bytes (9 words) so
//    that lanes reading consecutive key rows hit distinct banks.
// 2. Each warp owns query rows i. Lane l holds keys l and l + 32: dp4a scores
//    → attn1 codes clip(round(acc·rq)) → clip(round((attn1·s1 + bias[h,i,j])
//    ·inv_s2)) (qact2 codes) → + mask[w mod nW, i, j] (already divided by s2,
//    added unrounded) → with LIS, p2v::lis_row (common.cuh, shared with the
//    ViT kernel): the int-exp, the exact two-limb exp_sum, integer weights
//    2^(15−q); with LIS off, p2v::softmax_row at scale s2.
// 3. attn@v: lane l is output dim l. LIS: the shift-accumulate Σ_j w_j·v[j][l]
//    in int32 over warp-shuffled weights, out = clip(round(av·2^-15·ro)).
//    LIS off: Σ_j p_j·v[j][l] in float64 (exact products), rounded once,
//    out = clip(round(av·ro)).
//
// Bound: the per-score softmax chain (an IEEE divide per score and per weight)
// and the bias/mask reads from L2 (2 × N² floats per block); the dp4a work
// is 8 instructions per score. At Swin-T batch 64, stage 0 launches
// 64·64·3 = 12,288 blocks.
#include "common.cuh"

namespace {

constexpr int D = 32;
constexpr int NMAX = 64;
constexpr int JT = NMAX / 32;  // key slots per lane
constexpr int QROW = 36;       // smem bytes per q/k/v row

// scal: rq, s1, inv_s2, ro, x0_int, b_int, c_int, s2
template <bool LIS>
__global__ void __launch_bounds__(p2v::kThreads)
    swin_attention_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, const float* __restrict__ scal,
                          int8_t* __restrict__ out, int N, int C, int H, int nW) {
  __shared__ __align__(16) int8_t sm[3 * NMAX * QROW];
  const int win = blockIdx.x / H, head = blockIdx.x % H;
  const int8_t* base = qkv + (size_t)win * N * 3 * C + head * D;
  for (int idx = threadIdx.x; idx < 3 * N * (D / 4); idx += p2v::kThreads) {
    const int r = idx / (D / 4), u = idx % (D / 4);
    const int which = r / N, i = r % N;  // which: 0 q, 1 k, 2 v
    *reinterpret_cast<uint32_t*>(sm + (which * NMAX + i) * QROW + 4 * u) =
        p2v::ld32(base + (size_t)i * 3 * C + which * C + 4 * u);
  }
  __syncthreads();
  const int8_t* qs = sm;
  const int8_t* ks = sm + NMAX * QROW;
  const int8_t* vs = sm + 2 * NMAX * QROW;

  const float rq = scal[0], s1 = scal[1], inv_s2 = scal[2], ro = scal[3];
  const float x0 = scal[4], b_int = scal[5], c_int = scal[6];
  const float* bh = bias + (size_t)head * N * N;
  const float* mw = mask != nullptr ? mask + (size_t)(win % nW) * N * N : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < N; i += p2v::kThreads / 32) {
    uint32_t qv[D / 4];
#pragma unroll
    for (int u = 0; u < D / 4; ++u) qv[u] = p2v::ld32(qs + i * QROW + 4 * u);

    float ac[JT];
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      ac[t] = 0.f;
      if (j < N) {
        int s = 0;
#pragma unroll
        for (int u = 0; u < D / 4; ++u)
          s = __dp4a(static_cast<int>(qv[u]), static_cast<int>(p2v::ld32(ks + j * QROW + 4 * u)), s);
        const float a1 = p2v::requant(__fmul_rn(__int2float_rn(s), rq), -128.f, 127.f);
        float a2 = p2v::requant(__fmul_rn(__fadd_rn(__fmul_rn(a1, s1), bh[i * N + j]), inv_s2),
                                -128.f, 127.f);
        if (mw != nullptr) a2 = __fadd_rn(a2, mw[i * N + j]);
        ac[t] = a2;
      }
    }
    float o;
    if constexpr (LIS) {
      int wt[JT];
      p2v::lis_row<JT>(ac, N, x0, b_int, c_int, wt);
      int acc = 0;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        for (int src = 0; src < 32; ++src) {
          const int j = 32 * t + src;
          if (j >= N) break;
          const int wj = __shfl_sync(0xffffffffu, wt[t], src);
          acc += wj * static_cast<int>(vs[j * QROW + lane]);
        }
      }
      o = __fmul_rn(__fmul_rn(__int2float_rn(acc), 0x1p-15f), ro);
    } else {
      float p[JT];
      p2v::softmax_row<JT>(ac, N, scal[7], p);
      double acc = 0.0;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        for (int src = 0; src < 32; ++src) {
          const int j = 32 * t + src;
          if (j >= N) break;
          const double pj = static_cast<double>(__shfl_sync(0xffffffffu, p[t], src));
          acc = __dadd_rn(acc, __dmul_rn(pj, static_cast<double>(vs[j * QROW + lane])));
        }
      }
      o = __fmul_rn(__double2float_rn(acc), ro);
    }
    out[((size_t)win * N + i) * C + head * D + lane] = p2v::to_i8(p2v::requant(o, -128.f, 127.f));
  }
}

}  // namespace

extern "C" int p2v_swin_lis_attention(const void* qkv, const void* bias, const void* mask,
                                      const void* scal, void* out, int W, int N, int C, int H,
                                      int nW, int lis, void* stream) {
  if (W == 0) return 0;
  auto kernel = lis ? swin_attention_kernel<true> : swin_attention_kernel<false>;
  kernel<<<W * H, p2v::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(scal), static_cast<int8_t*>(out),
      N, C, H, nW);
  return static_cast<int>(cudaGetLastError());
}
