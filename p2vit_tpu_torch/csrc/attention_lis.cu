// int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax, over
// head_dim D = 64 (ops/attention_lis.py). Three entries share one per-row
// body (attend_rows) over q/k/v rows held in shared memory:
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
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int QROW = 68;  // smem bytes per q/k/v row
constexpr int NMAX = 256;
constexpr int JT = NMAX / 32;  // key slots per lane
using G = p2v::Gemm<64, 3 * D, 2, 4>;

// Query rows warp, warp + 8, ... of one (image, head). qs/ks/vs: the head's
// q/k/v rows, ld bytes apart; out: the head's output row 0, rows out_ld bytes
// apart. scal: rq, s_attn, ro, x0_int, b_int, c_int.
template <bool LIS>
__device__ void attend_rows(const int8_t* qs, const int8_t* ks, const int8_t* vs, int ld, int N,
                            const float* __restrict__ scal, int8_t* out, size_t out_ld) {
  const float rq = scal[0], s_attn = scal[1], ro = scal[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < N; i += p2v::kThreads / 32) {
    uint32_t qv[D / 4];
#pragma unroll
    for (int u = 0; u < D / 4; ++u) qv[u] = p2v::ld32(qs + i * ld + 4 * u);

    float ac[JT];
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      ac[t] = 0.f;
      if (j < N) {
        int s = 0;
#pragma unroll
        for (int u = 0; u < D / 4; ++u)
          s = __dp4a(static_cast<int>(qv[u]), static_cast<int>(p2v::ld32(ks + j * ld + 4 * u)), s);
        ac[t] = p2v::requant(__fmul_rn(__int2float_rn(s), rq), -128.f, 127.f);
      }
    }

    float o0, o1;
    if constexpr (LIS) {
      int wt[JT];
      p2v::lis_row<JT>(ac, N, scal[3], scal[4], scal[5], wt);
      int a0 = 0, a1 = 0;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        for (int src = 0; src < 32; ++src) {
          const int j = 32 * t + src;
          if (j >= N) break;
          const int wj = __shfl_sync(0xffffffffu, wt[t], src);
          const uint16_t v2 = *reinterpret_cast<const uint16_t*>(vs + j * ld + 2 * lane);
          a0 += wj * static_cast<int>(static_cast<int8_t>(v2 & 0xFF));
          a1 += wj * static_cast<int>(static_cast<int8_t>(v2 >> 8));
        }
      }
      o0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), 0x1p-15f), ro);
      o1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), 0x1p-15f), ro);
    } else {
      float p[JT];
      p2v::softmax_row<JT>(ac, N, s_attn, p);
      double a0 = 0.0, a1 = 0.0;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        for (int src = 0; src < 32; ++src) {
          const int j = 32 * t + src;
          if (j >= N) break;
          const double pj = static_cast<double>(__shfl_sync(0xffffffffu, p[t], src));
          const uint16_t v2 = *reinterpret_cast<const uint16_t*>(vs + j * ld + 2 * lane);
          a0 = __dadd_rn(a0, __dmul_rn(pj, static_cast<double>(static_cast<int8_t>(v2 & 0xFF))));
          a1 = __dadd_rn(a1, __dmul_rn(pj, static_cast<double>(static_cast<int8_t>(v2 >> 8))));
        }
      }
      o0 = __fmul_rn(__double2float_rn(a0), ro);
      o1 = __fmul_rn(__double2float_rn(a1), ro);
    }
    char2 o;
    o.x = p2v::to_i8(p2v::requant(o0, -128.f, 127.f));
    o.y = p2v::to_i8(p2v::requant(o1, -128.f, 127.f));
    *reinterpret_cast<char2*>(out + i * out_ld + 2 * lane) = o;
  }
}

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
  const int outer = blockIdx.x / H, head = blockIdx.x % H;
  const size_t off = outer * in_outer + head * D;
  for (int idx = threadIdx.x; idx < 3 * N * (D / 4); idx += p2v::kThreads) {
    const int r = idx / (D / 4), u = idx % (D / 4);
    const int which = r / N, i = r % N;  // which: 0 q, 1 k, 2 v
    const int8_t* src = which == 0 ? q : (which == 1 ? k : v);
    *reinterpret_cast<uint32_t*>(dsmem + r * QROW + 4 * u) = p2v::ld32(src + off + (size_t)i * in_ld + 4 * u);
  }
  __syncthreads();
  attend_rows<LIS>(dsmem, dsmem + N * QROW, dsmem + 2 * N * QROW, QROW, N, scal,
                   out + outer * out_outer + head * D, out_ld);
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
