// Standalone integer LayerNorm kernels on int8 codes (ops/intln.py).
//
// Replace the Pallas kernels p2vit_tpu/ops/intln.py:int_ln_requant
// (_kernel) and int_res_ln_requant (_res_kernel).
//
//   int_ln_requant:     x = codes·mask;  out = clip(round(LN(x)·ratio))
//   int_res_ln_requant: res = clip(round((a·s_a + b·s_b)·inv_s_out)),
//                       ln  = clip(round(LN(res·mask)·ratio))
//
// LN is p2v::ln_row / ln_elem (ops/intln.ln_mn_chain). One warp per row,
// rows up to C = 3072 with C % 4 == 0: lanes read the row as 4-byte words,
// sum Σx in int32 and Σx² in int64 (C·1024² passes 2^31 at C = 2048), exact
// whatever the order, then read the row again (L1/L2) for the elementwise
// chain and store 4-byte words. The residual operands are requantized in
// both passes instead of keeping a row buffer. Bound: memory (a few flops
// per byte); 8 rows per 256-thread block.
#include "common.cuh"

namespace {

constexpr int kWarps = p2v::kThreads / 32;

__device__ __forceinline__ float byte_of(uint32_t w, int e) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * e)));
}

__device__ __forceinline__ uint32_t pack_byte(float code, int e) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p2v::to_i8(code))) << (8 * e);
}

// warp sums of the row's exact integer moments → the LN row constants
__device__ __forceinline__ p2v::LnRow row_consts(long long sx, long long sxx, float s1, int C) {
  sx = p2v::warp_sum(sx);
  sxx = p2v::warp_sum(sxx);
  return p2v::ln_row(__ll2float_rn(sx), __ll2float_rn(sxx), s1, static_cast<float>(C));
}

// vecs rows: mask, w_os, b_os, ratio (each C)
__global__ void __launch_bounds__(p2v::kThreads)
    int_ln_requant_kernel(const int8_t* __restrict__ codes, const float* __restrict__ vecs,
                          const float* __restrict__ s1p, int8_t* __restrict__ out, int M, int C) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps leave together
  const float *mask = vecs, *w_os = vecs + C, *b_os = vecs + 2 * C, *ratio = vecs + 3 * C;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(codes + (size_t)m * C);
  const int nw = C / 4;
  long long sx = 0, sxx = 0;
  for (int u = lane; u < nw; u += 32) {
    const uint32_t w4 = row[u];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long x = static_cast<long long>(__fmul_rn(byte_of(w4, e), mask[4 * u + e]));
      sx += x;
      sxx += x * x;
    }
  }
  const p2v::LnRow lr = row_consts(sx, sxx, s1p[0], C);
  uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)m * C);
  for (int u = lane; u < nw; u += 32) {
    const uint32_t w4 = row[u];
    uint32_t o = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * u + e;
      const float y = p2v::ln_elem(lr, __fmul_rn(byte_of(w4, e), mask[c]), w_os[c], b_os[c]);
      o |= pack_byte(p2v::requant(__fmul_rn(y, ratio[c]), -128.f, 127.f), e);
    }
    orow[u] = o;
  }
}

// vecs rows: s_a, s_b, inv_s_out, mask, w_os, b_os, ratio (each C)
__device__ __forceinline__ float res_code(const float* vecs, int C, int c, float a, float b) {
  const float val = __fadd_rn(__fmul_rn(a, vecs[c]), __fmul_rn(b, vecs[C + c]));
  return p2v::requant(__fmul_rn(val, vecs[2 * C + c]), -128.f, 127.f);
}

__global__ void __launch_bounds__(p2v::kThreads)
    int_res_ln_requant_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                              const float* __restrict__ vecs, const float* __restrict__ s1p,
                              int8_t* __restrict__ res_out, int8_t* __restrict__ ln_out, int M,
                              int C) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const float *mask = vecs + 3 * C, *w_os = vecs + 4 * C, *b_os = vecs + 5 * C, *ratio = vecs + 6 * C;
  const size_t off = (size_t)m * C;
  const uint32_t* ra = reinterpret_cast<const uint32_t*>(a + off);
  const uint32_t* rb = reinterpret_cast<const uint32_t*>(b + off);
  uint32_t* ro = reinterpret_cast<uint32_t*>(res_out + off);
  uint32_t* lo = reinterpret_cast<uint32_t*>(ln_out + off);
  const int nw = C / 4;
  long long sx = 0, sxx = 0;
  for (int u = lane; u < nw; u += 32) {
    const uint32_t a4 = ra[u], b4 = rb[u];
    uint32_t o = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * u + e;
      const float code = res_code(vecs, C, c, byte_of(a4, e), byte_of(b4, e));
      o |= pack_byte(code, e);
      const long long x = static_cast<long long>(__fmul_rn(code, mask[c]));
      sx += x;
      sxx += x * x;
    }
    ro[u] = o;
  }
  const p2v::LnRow lr = row_consts(sx, sxx, s1p[0], C);
  for (int u = lane; u < nw; u += 32) {
    const uint32_t a4 = ra[u], b4 = rb[u];
    uint32_t o = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * u + e;
      const float x = __fmul_rn(res_code(vecs, C, c, byte_of(a4, e), byte_of(b4, e)), mask[c]);
      const float y = p2v::ln_elem(lr, x, w_os[c], b_os[c]);
      o |= pack_byte(p2v::requant(__fmul_rn(y, ratio[c]), -128.f, 127.f), e);
    }
    lo[u] = o;
  }
}

}  // namespace

extern "C" int p2v_int_ln_requant(const void* codes, const void* vecs, const void* s1, void* out,
                                  int M, int C, void* stream) {
  if (M == 0) return 0;
  int_ln_requant_kernel<<<(M + kWarps - 1) / kWarps, p2v::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(vecs),
      static_cast<const float*>(s1), static_cast<int8_t*>(out), M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2v_int_res_ln_requant(const void* a, const void* b, const void* vecs,
                                      const void* s1, void* res_out, void* ln_out, int M, int C,
                                      void* stream) {
  if (M == 0) return 0;
  int_res_ln_requant_kernel<<<(M + kWarps - 1) / kWarps, p2v::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(vecs), static_cast<const float*>(s1),
      static_cast<int8_t*>(res_out), static_cast<int8_t*>(ln_out), M, C);
  return static_cast<int>(cudaGetLastError());
}
