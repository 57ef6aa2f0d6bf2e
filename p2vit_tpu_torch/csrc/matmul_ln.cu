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
#include "common.cuh"

namespace {

constexpr int BM = 32;
using G = p2v::Gemm<BM, 128, 2, 4>;

// vecs rows: r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio (each N)
__global__ void __launch_bounds__(p2v::kThreads)
    matmul_res_ln_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                         const int8_t* __restrict__ res, const float* __restrict__ vecs,
                         const float* __restrict__ s1p, int8_t* __restrict__ res_out,
                         int8_t* __restrict__ ln_out, int M, int N, int K, int qmin, int qmax) {
  extern __shared__ __align__(16) int8_t dsmem[];
  int* rowbuf = reinterpret_cast<int*>(dsmem + G::SMEM_BYTES);  // [BM][N]
  const int m0 = blockIdx.x * BM;
  for (int n0 = 0; n0 < N; n0 += 128) {
    int acc[G::MT][G::NT][4];
    G::run([&](int rr) -> const int8_t* { return m0 + rr < M ? x + (size_t)(m0 + rr) * K : nullptr; },
           [&](int rr) -> const int8_t* { return n0 + rr < N ? w + (size_t)(n0 + rr) * K : nullptr; },
           K, dsmem, acc);
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + G::col_of(j, e);
        if (c < N) rowbuf[G::row_of(0, e) * N + c] = acc[0][j][e];
      }
  }
  __syncthreads();

  const float *r = vecs, *b = vecs + N, *s_mid = vecs + 2 * N, *s_res = vecs + 3 * N,
              *inv_s_out = vecs + 4 * N, *mask = vecs + 5 * N, *w_os = vecs + 6 * N,
              *b_os = vecs + 7 * N, *ratio = vecs + 8 * N;
  const float s1 = s1p[0], cf = static_cast<float>(N);
  const float lo = static_cast<float>(qmin), hi = static_cast<float>(qmax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < BM; rr += p2v::kThreads / 32) {
    const int m = m0 + rr;
    if (m >= M) break;
    int* row = rowbuf + rr * N;
    const size_t base = (size_t)m * N;
    int sx = 0, sxx = 0;
    for (int c = lane; c < N; c += 32) {
      const float mid = p2v::requant(__fadd_rn(__fmul_rn(__int2float_rn(row[c]), r[c]), b[c]), lo, hi);
      const float val = __fadd_rn(__fmul_rn(mid, s_mid[c]),
                                  __fmul_rn(static_cast<float>(res[base + c]), s_res[c]));
      const float code = p2v::requant(__fmul_rn(val, inv_s_out[c]), lo, hi);
      res_out[base + c] = p2v::to_i8(code);
      const int xi = static_cast<int>(__fmul_rn(code, mask[c]));
      row[c] = xi;  // this lane owns column c of the row
      sx += xi;
      sxx += xi * xi;
    }
    sx = p2v::warp_sum(sx);
    sxx = p2v::warp_sum(sxx);
    const p2v::LnRow lr = p2v::ln_row(__int2float_rn(sx), __int2float_rn(sxx), s1, cf);
    for (int c = lane; c < N; c += 32) {
      const float y = p2v::ln_elem(lr, static_cast<float>(row[c]), w_os[c], b_os[c]);
      ln_out[base + c] = p2v::to_i8(p2v::requant(__fmul_rn(y, ratio[c]), lo, hi));
    }
  }
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
