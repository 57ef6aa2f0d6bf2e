// int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax, over
// head_dim D = 64 (ops/attention_lis.py). Three entries share one per-row
// body (attend_rows, in attention_rows.cuh with the per-item row copy, so
// that the fused encoder layer runs it too) over q/k/v rows held in shared
// memory:
//
// * p2v_lis_attention_qkv_fused replaces the Pallas kernel
//   p2vit_tpu/ops/attention_lis.py:lis_attention_qkv_fused (_qkv_fused_kernel
//   -> heads_attention). One block per (image, head): the head's 3·D qkv
//   columns are a Gemm of the image's (N, Cin) codes against the gathered
//   weight rows {q, k, v}·C + head·D + dd, requantized to int8 codes into
//   shared memory.
// * p2v_lis_attention_fused replaces lis_attention_fused (_fused_kernel ->
//   heads_attention): one block per (image, head) copies the head's q/k/v
//   rows out of the (B, N, 3C) qkv codes.
// * p2v_lis_attention replaces lis_attention (_kernel): one block per
//   (batch·head) copies its rows out of split (BH, N, D) q, k and v.
//
// Shared rows are 68 bytes (17 words), so the per-lane key rows fall in
// distinct banks. Nothing is padded: rows and keys past N are never read.
// Per query row, a warp: 32 lanes × 8 key slots of dp4a scores → attn codes
// clip(round(acc·rq)); then
// * LIS: p2v::lis_row (common.cuh, shared with csrc/swin_attention.cu), the
//   integer weights 2^(15−q), and attn@v as the paper's shift-accumulate:
//   lane l sums output dims 2l, 2l+1 over all keys in int32, weights
//   broadcast by warp shuffle. Exact while |Σ_j v_j·2^(15−q_j)| < 2^24, i.e.
//   while a row's LIS weights sum below 4 (they sum to about 1). out =
//   clip(round(av_int·2^-15·ro)).
// * LIS off: p2v::softmax_row, then Σ_j p_j·v_j in float64 (each product of
//   a float32 and an int8 is exact there), rounded once to float32, out =
//   clip(round(av·ro)).
//
// Bound: the per-score softmax chain (an IEEE divide and an exponent
// extraction per score with LIS; a float64 exp per score without) and
// shared-memory reads; the qkv Gemm is a third of the qkv-fused block's MACs.
#include "attention_rows.cuh"

namespace {

using namespace p2v::vit_attn;
using G = p2v::Gemm<64, 3 * D, 2, 4>;

template <bool LIS>
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
  attend_rows<LIS>(qs, ks, vs, QROW, N, scal, out + (size_t)img * N * C + head * D, C);
}

// Block b = (outer, head) = (b / H, b % H): its q/k/v row i lies at
// {q,k,v} + outer·in_outer + head·D + i·in_ld; its output row i at
// out + outer·out_outer + head·D + i·out_ld.
template <bool LIS>
__global__ void __launch_bounds__(p2v::kThreads)
    attention_rows_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                          const int8_t* __restrict__ v, int in_ld, size_t in_outer,
                          const float* __restrict__ scal, int8_t* __restrict__ out, int out_ld,
                          size_t out_outer, int N, int H) {
  extern __shared__ __align__(16) int8_t dsmem[];
  attention_item<LIS>(q, k, v, in_ld, in_outer, scal, out, out_ld, out_outer, N, H, blockIdx.x, dsmem);
}

template <bool LIS>
int launch_rows(const int8_t* q, const int8_t* k, const int8_t* v, int in_ld, size_t in_outer,
                const void* scal, void* out, int out_ld, size_t out_outer, int N, int H, int blocks,
                cudaStream_t stream) {
  const int smem = 3 * N * QROW;
  cudaError_t err = p2v::set_smem(attention_rows_kernel<LIS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_rows_kernel<LIS><<<blocks, p2v::kThreads, smem, stream>>>(
      q, k, v, in_ld, in_outer, static_cast<const float*>(scal), static_cast<int8_t*>(out), out_ld,
      out_outer, N, H);
  return static_cast<int>(cudaGetLastError());
}

template <bool LIS>
int launch_qkv(const void* h, const void* w, const void* r, const void* b, const void* scal,
               void* out, int B, int N, int Cin, int C, int H, cudaStream_t stream) {
  const int smem = G::SMEM_BYTES + 3 * N * QROW;
  cudaError_t err = p2v::set_smem(lis_attention_qkv_kernel<LIS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lis_attention_qkv_kernel<LIS><<<B * H, p2v::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(h), static_cast<const int8_t*>(w), static_cast<const float*>(r),
      static_cast<const float*>(b), static_cast<const float*>(scal), static_cast<int8_t*>(out), N,
      Cin, C, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p2v_lis_attention_qkv_fused(const void* h, const void* w, const void* r,
                                           const void* b, const void* scal, void* out, int B,
                                           int N, int Cin, int C, int H, int lis, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return lis ? launch_qkv<true>(h, w, r, b, scal, out, B, N, Cin, C, H, s)
             : launch_qkv<false>(h, w, r, b, scal, out, B, N, Cin, C, H, s);
}

// (B, N, 3C) qkv codes -> (B, N, C)
extern "C" int p2v_lis_attention_fused(const void* qkv, const void* scal, void* out, int B, int N,
                                       int C, int H, int lis, void* stream) {
  if (B == 0) return 0;
  auto q = static_cast<const int8_t*>(qkv);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t in_outer = (size_t)N * 3 * C, out_outer = (size_t)N * C;
  return lis ? launch_rows<true>(q, q + C, q + 2 * C, 3 * C, in_outer, scal, out, C, out_outer, N, H,
                                 B * H, s)
             : launch_rows<false>(q, q + C, q + 2 * C, 3 * C, in_outer, scal, out, C, out_outer, N, H,
                                  B * H, s);
}

// (BH, N, D) q, k, v codes -> (BH, N, D)
extern "C" int p2v_lis_attention(const void* q, const void* k, const void* v, const void* scal,
                                 void* out, int BH, int N, int lis, void* stream) {
  if (BH == 0) return 0;
  auto qp = static_cast<const int8_t*>(q), kp = static_cast<const int8_t*>(k),
       vp = static_cast<const int8_t*>(v);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t outer = (size_t)N * D;
  return lis ? launch_rows<true>(qp, kp, vp, D, outer, scal, out, D, outer, N, 1, BH, s)
             : launch_rows<false>(qp, kp, vp, D, outer, scal, out, D, outer, N, 1, BH, s);
}
