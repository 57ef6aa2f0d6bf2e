// int8 matmul with the fused PoT requant epilogue (ops/matmul_int8.py), over
// an int8 weight store or an int4-packed one.
//
// Replaces the Pallas kernels p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant
// and :int4_matmul_requant (the packed store, _packed_kernel).
// out[m, n] = clip(round(acc·r[n] + b[n]))                 (gelu = 0)
//           = clip(round(GELU(acc·r[n] + b[n])·out_inv))   (gelu = 1)
// acc = Σ_k x[m, k]·w[n, k], exact in int32 (mma.sync s8·s8 → s32).
//
// One 128x128 output tile per block; edges are masked in the tile loads and
// the stores, so M, N need no padding. Bound: tensor-core issue at fc1's
// shapes (M = B·197, N = 1536, K = 384); the head (M = B) is launch-bound.
// The int4 store halves the weight bytes, which bound the GEMM only at small
// M (a few hundred rows); its B chunks are unpacked with plain 16-byte loads
// (shift, mask, sign-extend four bytes at a time) into the same int8 stage,
// so the tensor-core loop and the epilogue are the int8 kernel's.
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

// The int4-store kernel: the same tile, its B rows unpacked from the packed
// store (p2v::PackedInt4Rows) into the int8 stage; K = 2·khalf.
__global__ void __launch_bounds__(p2v::kThreads)
    int4_matmul_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                               const float* __restrict__ r, const float* __restrict__ b,
                               const float* __restrict__ scal, int8_t* __restrict__ out, int M,
                               int N, int K, int qmin, int qmax, int gelu) {
  __shared__ __align__(16) int8_t smem[p2v::RequantGemm::SMEM_BYTES];
  const int n0 = blockIdx.x * 128;
  p2v::requant_tile(x, p2v::PackedInt4Rows{wp, n0, N, K / 2}, r, b, scal[0], out, M, N, K,
                    static_cast<float>(qmin), static_cast<float>(qmax), gelu != 0, blockIdx.y * 128, n0,
                    smem);
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

// x (M, K) int8 codes, K = 2·khalf with khalf % 16 == 0; wp (N, khalf) the
// pack_int4 store.
extern "C" int p2v_int4_matmul_requant(const void* x, const void* wp, const void* r, const void* b,
                                       const void* scal, void* out, int M, int N, int K, int qmin,
                                       int qmax, int gelu, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + 127) / 128, (M + 127) / 128);
  int4_matmul_requant_kernel<<<grid, p2v::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp), static_cast<const float*>(r),
      static_cast<const float*>(b), static_cast<const float*>(scal), static_cast<int8_t*>(out), M,
      N, K, qmin, qmax, gelu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* p2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
