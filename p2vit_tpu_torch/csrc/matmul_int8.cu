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
#include "matmul_tiles.cuh"

namespace {

__global__ void __launch_bounds__(p2v::kThreads)
    int8_matmul_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                               const float* __restrict__ r, const float* __restrict__ b,
                               const float* __restrict__ scal, int8_t* __restrict__ out, int M,
                               int N, int K, int qmin, int qmax, int gelu) {
  __shared__ __align__(16) int8_t smem[p2v::RequantGemm::SMEM_BYTES];
  p2v::matmul_requant_tile(x, w, r, b, scal[0], out, M, N, K, static_cast<float>(qmin),
                           static_cast<float>(qmax), gelu != 0, blockIdx.y * 128, blockIdx.x * 128, smem);
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
