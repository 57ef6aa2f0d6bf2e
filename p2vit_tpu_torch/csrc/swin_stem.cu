// The Swin patch stem fused end to end (ops/swin_stem.py fused_swin_stem).
//
// Replaces the Pallas kernel p2vit_tpu/ops/swin_stem.py:fused_swin_stem
// (_kernel). Per patch row m of the (M, K) float32 patch matrix:
//
//   h     = Σ_k px[m,k]·w[c,k] + bias[c]      (float32, k = 0..K-1 in order)
//   code  = clip(round(h·inv_sbn[c]))          (patch_qact_bn codes)
//   x     = code·mask[c]                        (PTF-aligned)
//   out   = clip(round(LN(x)))                  (p2v::ln_row / ln_elem)
//
// The dot is summed in a fixed order, k = 0 first, each product and each add
// rounded on its own (__fmul_rn / __fadd_rn, --fmad=false), the order of the
// plain version's loop, so the two agree bit for bit on any input. The LN row
// sums Σx and Σx² are exact int64 warp sums.
//
// Layout: the (C, K) weight, stored transposed as (K, C) so that lanes read
// consecutive channels, and the five (C,) vectors live in shared memory
// (18.8 KB at Swin-T's C = 96, K = 48); each warp stages its patch row in
// shared memory and lane l computes channels l, l + 32, ... (C ≤ 256).
// Warps stride over rows, so a block loads the weight once for many rows.
//
// Bound: the float32 dot, 2·M·C·K operations (1.85 GFLOP at Swin-T batch 64,
// M = 200,704), over 58 MB of patch reads and code writes; written with
// separate multiply and add, it runs at most half the FMA peak.
#include "common.cuh"

namespace {

constexpr int kWarps = p2v::kThreads / 32;
constexpr int CT = 8;  // channel slots per lane: C ≤ 256

// vecs rows: bias, inv_sbn, mask, w_os, b_os (each C)
__global__ void __launch_bounds__(p2v::kThreads)
    swin_stem_kernel(const float* __restrict__ px, const float* __restrict__ w,
                     const float* __restrict__ vecs, const float* __restrict__ s1p,
                     int8_t* __restrict__ out, int M, int K, int C) {
  extern __shared__ float sm[];
  float* wt = sm;           // (K, C)
  float* vs = wt + K * C;   // (5, C)
  float* xs = vs + 5 * C;   // (kWarps, K)
  for (int idx = threadIdx.x; idx < K * C; idx += p2v::kThreads) wt[(idx % K) * C + idx / K] = w[idx];
  for (int idx = threadIdx.x; idx < 5 * C; idx += p2v::kThreads) vs[idx] = vecs[idx];
  __syncthreads();
  const float *bias = vs, *inv_sbn = vs + C, *mask = vs + 2 * C, *w_os = vs + 3 * C,
              *b_os = vs + 4 * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xr = xs + warp * K;
  const float s1 = s1p[0];
  for (int m = blockIdx.x * kWarps + warp; m < M; m += gridDim.x * kWarps) {
    for (int k = lane; k < K; k += 32) xr[k] = px[(size_t)m * K + k];
    __syncwarp();
    float x[CT];
    long long sx = 0, sxx = 0;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      x[t] = 0.f;
      if (c < C) {
        float h = 0.f;
        for (int k = 0; k < K; ++k) h = __fadd_rn(h, __fmul_rn(xr[k], wt[k * C + c]));
        h = __fadd_rn(h, bias[c]);
        x[t] = __fmul_rn(p2v::requant(__fmul_rn(h, inv_sbn[c]), -128.f, 127.f), mask[c]);
        const long long xi = static_cast<long long>(x[t]);
        sx += xi;
        sxx += xi * xi;
      }
    }
    __syncwarp();  // the next row overwrites xr
    sx = p2v::warp_sum(sx);
    sxx = p2v::warp_sum(sxx);
    const p2v::LnRow lr =
        p2v::ln_row(__ll2float_rn(sx), __ll2float_rn(sxx), s1, static_cast<float>(C));
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = lane + 32 * t;
      if (c < C)
        out[(size_t)m * C + c] =
            p2v::to_i8(p2v::requant(p2v::ln_elem(lr, x[t], w_os[c], b_os[c]), -128.f, 127.f));
    }
  }
}

}  // namespace

extern "C" int p2v_fused_swin_stem(const void* px, const void* w, const void* vecs,
                                   const void* s1, void* out, int M, int K, int C, void* stream) {
  if (M == 0) return 0;
  const int smem = static_cast<int>(sizeof(float)) * (K * C + 5 * C + kWarps * K);
  cudaError_t err = p2v::set_smem(swin_stem_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows_of_warps = (M + kWarps - 1) / kWarps;
  const int blocks = rows_of_warps < 8 * sms ? rows_of_warps : 8 * sms;
  swin_stem_kernel<<<blocks, p2v::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(w), static_cast<const float*>(vecs),
      static_cast<const float*>(s1), static_cast<int8_t*>(out), M, K, C);
  return static_cast<int>(cudaGetLastError());
}
