// int8 matmul + residual junction + the following integer LN (ops/matmul_ln.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/matmul_ln.py:int8_matmul_res_ln.
// Per row m:  mid = clip(round(acc·r + b)); res = clip(round((mid·s_mid +
// res_in·s_res)·inv_s_out)); ln = clip(round(LN(res·mask)·ratio)).
//
// The LN needs the whole row, so a block owns 32 rows at full width N
// (N ≤ 1024): the Gemm sweeps the row in 128-column chunks into an int32 row
// buffer in shared memory (32·N·4 bytes), then each warp runs the epilogue
// on whole rows. Σx and Σx² are int32 warp sums (|x| ≤ 1024, so Σx² < 2^31
// for N ≤ 1024): exact, whatever the order. Bound: tensor-core issue for fc2
// (K = 1536); the weight panel is re-read from L2 by every 32-row block.
#include "matmul_tiles.cuh"

namespace {

constexpr int BM = p2v::kLnRows;
using G = p2v::LnGemm;

// vecs rows: r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio (each N)
__global__ void __launch_bounds__(p2v::kThreads)
    matmul_res_ln_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                         const int8_t* __restrict__ res, const float* __restrict__ vecs,
                         const float* __restrict__ s1p, int8_t* __restrict__ res_out,
                         int8_t* __restrict__ ln_out, int M, int N, int K, int qmin, int qmax) {
  extern __shared__ __align__(16) int8_t dsmem[];
  int* rowbuf = reinterpret_cast<int*>(dsmem + G::SMEM_BYTES);  // [BM][N]
  const int m0 = blockIdx.x * BM;
  p2v::gemm_rows<false>(
      [&](int rr) -> const int8_t* { return m0 + rr < M ? x + (size_t)(m0 + rr) * K : nullptr; },
      nullptr, 0, w, N, K, rowbuf, dsmem);
  __syncthreads();
  const size_t base = (size_t)m0 * N;
  p2v::res_ln_rows(rowbuf, N, min(BM, M - m0), res + base, N, vecs, s1p[0], res_out + base, N,
                   ln_out + base, N, static_cast<float>(qmin), static_cast<float>(qmax));
}

}  // namespace

extern "C" int p2v_int8_matmul_res_ln(const void* x, const void* w, const void* res,
                                      const void* vecs, const void* s1, void* res_out,
                                      void* ln_out, int M, int N, int K, int qmin, int qmax,
                                      void* stream) {
  if (M == 0) return 0;
  const int smem = G::SMEM_BYTES + BM * N * 4;
  cudaError_t err = p2v::set_smem(matmul_res_ln_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_res_ln_kernel<<<(M + BM - 1) / BM, p2v::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const int8_t*>(res),
      static_cast<const float*>(vecs), static_cast<const float*>(s1), static_cast<int8_t*>(res_out),
      static_cast<int8_t*>(ln_out), M, N, K, qmin, qmax);
  return static_cast<int>(cudaGetLastError());
}
