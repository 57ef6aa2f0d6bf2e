// bf16 matmul over a streamed quantized weight store (ops/matmul_wstream.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/matmul_wstream.py:wstream_matmul.
//   out[m, n] = bf16([GELU](S[m, n]·r[n] + b[n]))
//   S = Σ_p fl32(A_p),  A_p = Σ_{k in panel p} x[m, k]·code[n, k]
// with the panels of the store's format (bf16 and i8: one panel of K; w8p:
// 4, w4p: 8 panels of pk words, ops/matmul_wstream.panel_len), the panel sums
// added in order p = 0..P−1, each operation rounded on its own.
//
// Numerics: every bf16 × code product has at most 16 significant bits, so
// A_p in float64 is exact, in any order, while the products of a row span
// ≤ 25 binades; fl32(A_p) then rounds once, and the kernel equals its plain
// version (a float64 matmul per panel) bit for bit. Scalar float64 FMAs
// accumulate A_p: a fused product-add of exact terms rounds nothing.
//
// Layout: one 64×64 output tile per block of 256 threads (4×4 outputs each),
// K staged 32 at a time through shared memory as float64 (x converted from
// bf16, the store unpacked to its integer codes or bf16 values), so the
// inner loop is loads and FMAs only. Slices past K (the packed stores' pad)
// hold zero activations and are skipped. Bound on this card: the float64
// FMA rate (67 TFLOP/s tensor, ~34 scalar) against the bf16 tensor-core peak
// the bound counts: this design trades speed for an exact, order-free sum.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
enum Format { kBf16 = 0, kI8 = 1, kW8p = 2, kW4p = 3 };

// code (or bf16 value) of row n at K index k, panel p (packed: word k − p·pk)
template <int FMT>
__device__ __forceinline__ double w_value(const void* w, int n, int k, int K, int pk, int p) {
  if constexpr (FMT == kBf16) {
    return k < K ? static_cast<double>(__bfloat162float(static_cast<const __nv_bfloat16*>(w)[(size_t)n * K + k]))
                 : 0.0;
  } else if constexpr (FMT == kI8) {
    return k < K ? static_cast<double>(static_cast<const int8_t*>(w)[(size_t)n * K + k]) : 0.0;
  } else {
    const uint32_t word = static_cast<const uint32_t*>(w)[(size_t)n * pk + (k - p * pk)];
    if constexpr (FMT == kW8p) {
      return static_cast<double>(static_cast<int8_t>((word >> (8 * p)) & 0xFFu));
    } else {
      return static_cast<double>((static_cast<int>((word >> (4 * p)) & 0xFu) ^ 8) - 8);
    }
  }
}

template <int FMT, int P>
__global__ void __launch_bounds__(p2v::kThreads)
    wstream_matmul_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                          const float* __restrict__ r, const float* __restrict__ b,
                          __nv_bfloat16* __restrict__ out, int M, int N, int K, int pk, int gelu) {
  __shared__ double xs[BK][BM + 1];
  __shared__ double ws[BK][BN + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float s[4][4];
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    double acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
    const int kend = min((p + 1) * pk, K);
    for (int k0 = p * pk; k0 < kend; k0 += BK) {
      // consecutive threads walk k: coalesced rows of x and of the store
      for (int e = threadIdx.x; e < BM * BK; e += p2v::kThreads) {
        const int mm = e / BK, kk = e % BK, m = m0 + mm, k = k0 + kk;
        xs[kk][mm] = (m < M && k < K) ? static_cast<double>(__bfloat162float(x[(size_t)m * K + k])) : 0.0;
      }
      for (int e = threadIdx.x; e < BN * BK; e += p2v::kThreads) {
        const int nn = e / BK, kk = e % BK, n = n0 + nn;
        ws[kk][nn] = n < N ? w_value<FMT>(w, n, k0 + kk, K, pk, p) : 0.0;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        double a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], c[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = __double2float_rn(acc[i][j]);
        s[i][j] = p == 0 ? v : __fadd_rn(s[i][j], v);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      float y = __fadd_rn(__fmul_rn(s[i][j], r[n]), b[n]);
      if (gelu) y = p2v::gelu_as(y);
      out[(size_t)m * N + n] = __float2bfloat16_rn(y);
    }
}

template <int FMT, int P>
cudaError_t launch(const void* x, const void* w, const void* r, const void* b, void* out, int M, int N, int K,
                   int pk, int gelu, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  wstream_matmul_kernel<FMT, P><<<grid, p2v::kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, static_cast<const float*>(r), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), M, N, K, pk, gelu);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16; w the store of format fmt (0 bf16 (N, K), 1 int8 (N, K),
// 2 w8p / 3 w4p int32 (N, pk)); r, b (N,) float32; out (M, N) bf16.
extern "C" int p2v_wstream_matmul(const void* x, const void* w, const void* r, const void* b, void* out,
                                  int M, int N, int K, int pk, int fmt, int gelu, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt) {
    case kBf16: err = launch<kBf16, 1>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    case kI8: err = launch<kI8, 1>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    case kW8p: err = launch<kW8p, 4>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    case kW4p: err = launch<kW4p, 8>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
