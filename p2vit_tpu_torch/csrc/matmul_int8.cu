// int8 matmul with the fused PoT requant epilogue (ops/matmul_int8.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant.
// out[m, n] = clip(round(acc·r[n] + b[n]))                 (gelu = 0)
//           = clip(round(GELU(acc·r[n] + b[n])·out_inv))   (gelu = 1)
// acc = Σ_k x[m, k]·w[n, k], exact in int32 (mma.sync s8·s8 → s32).
//
// One 128x128 output tile per block; edges are masked in the tile loads and
// the stores, so M, N need no padding. Bound: tensor-core issue at fc1's
// shapes (M = B·197, N = 1536, K = 384); the head (M = B) is launch-bound.
#include "common.cuh"

namespace {

using G = p2v::Gemm<128, 128, 2, 4>;

__global__ void __launch_bounds__(p2v::kThreads)
    int8_matmul_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                               const float* __restrict__ r, const float* __restrict__ b,
                               const float* __restrict__ scal, int8_t* __restrict__ out, int M,
                               int N, int K, int qmin, int qmax, int gelu) {
  __shared__ __align__(16) int8_t smem[G::SMEM_BYTES];
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  int acc[G::MT][G::NT][4];
  G::run([&](int rr) -> const int8_t* { return m0 + rr < M ? x + (size_t)(m0 + rr) * K : nullptr; },
         [&](int rr) -> const int8_t* { return n0 + rr < N ? w + (size_t)(n0 + rr) * K : nullptr; },
         K, smem, acc);
  const float out_inv = scal[0], lo = static_cast<float>(qmin), hi = static_cast<float>(qmax);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + G::row_of(i, e), n = n0 + G::col_of(j, e);
        if (m >= M || n >= N) continue;
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), r[n]), b[n]);
        if (gelu) y = __fmul_rn(p2v::gelu_as(y), out_inv);
        out[(size_t)m * N + n] = p2v::to_i8(p2v::requant(y, lo, hi));
      }
}

}  // namespace

extern "C" int p2v_int8_matmul_requant(const void* x, const void* w, const void* r, const void* b,
                                       const void* scal, void* out, int M, int N, int K, int qmin,
                                       int qmax, int gelu, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + 127) / 128, (M + 127) / 128);
  int8_matmul_requant_kernel<<<grid, p2v::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(r),
      static_cast<const float*>(b), static_cast<const float*>(scal), static_cast<int8_t*>(out), M,
      N, K, qmin, qmax, gelu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* p2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
