// Per-tile bodies of the int8 and int4 matmul kernels (csrc/matmul_int8.cu,
// csrc/matmul_ln.cu), shared with the fused encoder layer
// (csrc/layer_fused.cu): each path runs the same arithmetic, so the fused
// layer equals the four-kernel path bit for bit by construction.
#pragma once

#include "common.cuh"

namespace p2v {

// clip(round(acc·r + b)), or with gelu clip(round(GELU(acc·r + b)·out_inv))
__device__ __forceinline__ float requant_epilogue(int acc, float r, float b, float out_inv, bool gelu,
                                                  float lo, float hi) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), r), b);
  if (gelu) y = __fmul_rn(gelu_as(y), out_inv);
  return requant(y, lo, hi);
}

using RequantGemm = Gemm<128, 128, 2, 4>;

// Output tile (m0, n0) of out[M, N] = requant_epilogue(x[M, K] · Bᵀ), B's
// rows from b_row (int8 rows, or a PackedInt4Rows store); edges are masked in
// the loads and the stores.
template <class BRow>
__device__ __forceinline__ void requant_tile(const int8_t* x, BRow b_row, const float* r, const float* b,
                                             float out_inv, int8_t* out, int M, int N, int K, float lo,
                                             float hi, bool gelu, int m0, int n0, int8_t* smem) {
  using G = RequantGemm;
  int acc[G::MT][G::NT][4];
  G::run([&](int rr) -> const int8_t* { return m0 + rr < M ? x + (size_t)(m0 + rr) * K : nullptr; },
         b_row, K, smem, acc);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + G::row_of(i, e), n = n0 + G::col_of(j, e);
        if (m >= M || n >= N) continue;
        out[(size_t)m * N + n] = to_i8(requant_epilogue(acc[i][j][e], r[n], b[n], out_inv, gelu, lo, hi));
      }
}

// out[M, N] = requant_epilogue(x[M, K] · w[N, K]ᵀ), tile (m0, n0)
__device__ __forceinline__ void matmul_requant_tile(const int8_t* x, const int8_t* w, const float* r,
                                                    const float* b, float out_inv, int8_t* out,
                                                    int M, int N, int K, float lo, float hi,
                                                    bool gelu, int m0, int n0, int8_t* smem) {
  requant_tile(x, [&](int rr) -> const int8_t* { return n0 + rr < N ? w + (size_t)(n0 + rr) * K : nullptr; },
               r, b, out_inv, out, M, N, K, lo, hi, gelu, m0, n0, smem);
}

// The junction kernels own 32 whole rows of the output.
constexpr int kLnRows = 32;
using LnGemm = Gemm<kLnRows, 128, 2, 4>;

// int32 accumulators of a 32-row A tile against all N rows of w[N, K], into
// rowbuf[32][N], in 128-column chunks. A comes from a_row (global rows) or,
// with RESIDENT, from shared memory at sa, rows lda bytes apart.
template <bool RESIDENT, class ARow>
__device__ __forceinline__ void gemm_rows(ARow a_row, const int8_t* sa, int lda, const int8_t* w, int N,
                                          int K, int* rowbuf, int8_t* smem) {
  using G = LnGemm;
  for (int n0 = 0; n0 < N; n0 += 128) {
    int acc[G::MT][G::NT][4];
    auto b_row = [&](int rr) -> const int8_t* { return n0 + rr < N ? w + (size_t)(n0 + rr) * K : nullptr; };
    if constexpr (RESIDENT)
      G::run_resident(sa, lda, b_row, K, smem, acc);
    else
      G::run(a_row, b_row, K, smem, acc);
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + G::col_of(j, e);
        if (c < N) rowbuf[G::row_of(0, e) * N + c] = acc[0][j][e];
      }
  }
}

// The residual junction and the following integer LN on rows [0, rows) of
// rowbuf (ops/matmul_ln.py):
//   mid = clip(round(acc·r + b)); res = clip(round((mid·s_mid + res_in·s_res)·inv_s_out));
//   ln = clip(round(LN(res·mask)·ratio)).
// vecs rows: r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio (each N).
// Each warp owns whole rows; Σx and Σx² are int32 warp sums (|x| ≤ 1024, so
// Σx² < 2^31 for N ≤ 1024): exact, whatever the order. The row buffer then
// holds the masked residual codes. res_in / res_out / ln_out point at row 0
// of the tile, rows *_ld bytes apart, in global or shared memory.
__device__ __forceinline__ void res_ln_rows(int* rowbuf, int N, int rows, const int8_t* res_in, int res_ld,
                                            const float* vecs, float s1, int8_t* res_out, int res_out_ld,
                                            int8_t* ln_out, int ln_ld, float lo, float hi) {
  const float *r = vecs, *b = vecs + N, *s_mid = vecs + 2 * N, *s_res = vecs + 3 * N,
              *inv_s_out = vecs + 4 * N, *mask = vecs + 5 * N, *w_os = vecs + 6 * N,
              *b_os = vecs + 7 * N, *ratio = vecs + 8 * N;
  const float cf = static_cast<float>(N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < rows; rr += kThreads / 32) {
    int* row = rowbuf + rr * N;
    const int8_t* rin = res_in + (size_t)rr * res_ld;
    int8_t* rout = res_out + (size_t)rr * res_out_ld;
    int8_t* lout = ln_out + (size_t)rr * ln_ld;
    int sx = 0, sxx = 0;
    for (int c = lane; c < N; c += 32) {
      const float mid = requant(__fadd_rn(__fmul_rn(__int2float_rn(row[c]), r[c]), b[c]), lo, hi);
      const float val = __fadd_rn(__fmul_rn(mid, s_mid[c]), __fmul_rn(static_cast<float>(rin[c]), s_res[c]));
      const float code = requant(__fmul_rn(val, inv_s_out[c]), lo, hi);
      rout[c] = to_i8(code);
      const int xi = static_cast<int>(__fmul_rn(code, mask[c]));
      row[c] = xi;  // this lane owns column c of the row
      sx += xi;
      sxx += xi * xi;
    }
    sx = warp_sum(sx);
    sxx = warp_sum(sxx);
    const LnRow lr = ln_row(__int2float_rn(sx), __int2float_rn(sxx), s1, cf);
    for (int c = lane; c < N; c += 32) {
      const float y = ln_elem(lr, static_cast<float>(row[c]), w_os[c], b_os[c]);
      lout[c] = to_i8(requant(__fmul_rn(y, ratio[c]), lo, hi));
    }
  }
}

}  // namespace p2v
