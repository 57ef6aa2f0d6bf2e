// qkv projection + int8 attention with Log-Int-Softmax (ops/attention_lis.py).
//
// Replaces the Pallas kernel
// p2vit_tpu/ops/attention_lis.py:lis_attention_qkv_fused (_qkv_fused_kernel
// -> heads_attention). One block per (image, head), head_dim D = 64:
//
// 1. The head's 3·D qkv columns: Gemm of the image's (N, Cin) codes against
//    the gathered weight rows {q, k, v}·C + head·D + dd, requantized to int8
//    codes into shared memory (rows of 68 bytes: 17 words, so the per-lane
//    key rows below fall in distinct banks).
// 2. Each warp owns query rows. Per row: 32 lanes × 8 key slots of dp4a
//    scores → attn codes clip(round(acc·rq)); then p2v::lis_row
//    (common.cuh, shared with csrc/swin_attention.cu): warp max, the I-BERT
//    int-exp, the exact two-limb exp_sum, LIS code q = ⌊log2 round(Σ/e)⌋ +
//    tie, the weight as the integer 2^(15−q) (0 when q ≥ 16).
// 3. attn@v as the paper's shift-accumulate: lane l accumulates output dims
//    2l, 2l+1 over all keys in int32, weights broadcast by warp shuffle.
//    Exact while |av| < 2^9, i.e. |Σ_j v_j·2^(15−q_j)| < 2^24: with
//    |v| ≤ 128 this holds while a row's LIS weights sum below 4 (they sum to
//    about 1). Then out = clip(round(av_int·2^-15·ro)).
//
// Bound: the per-score LIS chain (one IEEE divide, exponent extraction) and
// shared-memory reads; the qkv Gemm is a third of the block's MACs.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int QROW = 68;  // smem bytes per q/k/v row
constexpr int NMAX = 256;
constexpr int JT = NMAX / 32;  // key slots per lane
using G = p2v::Gemm<64, 3 * D, 2, 4>;

// scal: rq, s_attn, ro, x0_int, b_int, c_int
__global__ void __launch_bounds__(p2v::kThreads)
    lis_attention_qkv_kernel(const int8_t* __restrict__ h, const int8_t* __restrict__ w,
                             const float* __restrict__ r, const float* __restrict__ bvec,
                             const float* __restrict__ scal, int8_t* __restrict__ out, int N,
                             int Cin, int C, int H) {
  extern __shared__ __align__(16) int8_t dsmem[];
  int8_t* qs = dsmem + G::SMEM_BYTES;
  int8_t* ks = qs + N * QROW;
  int8_t* vs = ks + N * QROW;
  const int img = blockIdx.x / H, head = blockIdx.x % H;
  const int8_t* hb = h + (size_t)img * N * Cin;

  for (int m0 = 0; m0 < N; m0 += 64) {
    int acc[G::MT][G::NT][4];
    G::run([&](int rr) -> const int8_t* { return m0 + rr < N ? hb + (size_t)(m0 + rr) * Cin : nullptr; },
           [&](int rr) -> const int8_t* {
             return w + (size_t)((rr / D) * C + head * D + rr % D) * Cin;
           },
           Cin, dsmem, acc);
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + G::row_of(i, e);
          if (row >= N) continue;
          const int col = G::col_of(j, e), which = col / D, dd = col % D;
          const int gn = which * C + head * D + dd;
          const float code =
              p2v::requant(__fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), r[gn]), bvec[gn]),
                           -128.f, 127.f);
          int8_t* dst = which == 0 ? qs : (which == 1 ? ks : vs);
          dst[row * QROW + dd] = p2v::to_i8(code);
        }
  }
  __syncthreads();

  const float rq = scal[0], ro = scal[2], x0 = scal[3], b_int = scal[4], c_int = scal[5];
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
        for (int u = 0; u < D / 4; ++u) s = __dp4a(static_cast<int>(qv[u]), static_cast<int>(p2v::ld32(ks + j * QROW + 4 * u)), s);
        ac[t] = p2v::requant(__fmul_rn(__int2float_rn(s), rq), -128.f, 127.f);
      }
    }
    int wt[JT];
    p2v::lis_row<JT>(ac, N, x0, b_int, c_int, wt);

    int a0 = 0, a1 = 0;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      for (int src = 0; src < 32; ++src) {
        const int j = 32 * t + src;
        if (j >= N) break;
        const int wj = __shfl_sync(0xffffffffu, wt[t], src);
        const uint16_t v2 = *reinterpret_cast<const uint16_t*>(vs + j * QROW + 2 * lane);
        a0 += wj * static_cast<int>(static_cast<int8_t>(v2 & 0xFF));
        a1 += wj * static_cast<int>(static_cast<int8_t>(v2 >> 8));
      }
    }
    const float o0 = p2v::requant(__fmul_rn(__fmul_rn(__int2float_rn(a0), 0x1p-15f), ro), -128.f, 127.f);
    const float o1 = p2v::requant(__fmul_rn(__fmul_rn(__int2float_rn(a1), 0x1p-15f), ro), -128.f, 127.f);
    char2 o;
    o.x = p2v::to_i8(o0);
    o.y = p2v::to_i8(o1);
    *reinterpret_cast<char2*>(out + ((size_t)img * N + i) * C + head * D + 2 * lane) = o;
  }
}

}  // namespace

extern "C" int p2v_lis_attention_qkv_fused(const void* h, const void* w, const void* r,
                                           const void* b, const void* scal, void* out, int B,
                                           int N, int Cin, int C, int H, void* stream) {
  if (B == 0) return 0;
  const int smem = G::SMEM_BYTES + 3 * N * QROW;
  cudaError_t err = p2v::set_smem(lis_attention_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lis_attention_qkv_kernel<<<B * H, p2v::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(h), static_cast<const int8_t*>(w), static_cast<const float*>(r),
      static_cast<const float*>(b), static_cast<const float*>(scal), static_cast<int8_t*>(out), N,
      Cin, C, H);
  return static_cast<int>(cudaGetLastError());
}
