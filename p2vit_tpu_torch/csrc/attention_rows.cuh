// The per-row attention body of the ViT attention kernels
// (csrc/attention_lis.cu), shared with the fused encoder layer
// (csrc/layer_fused.cu): one (image, head) item over q/k/v rows held in
// shared memory, head_dim 64, N ≤ 256. See attention_lis.cu for the
// arithmetic of both softmax arms.
#pragma once

#include "common.cuh"

namespace p2v {
namespace vit_attn {

constexpr int D = 64;
constexpr int QROW = 68;  // smem bytes per q/k/v row
constexpr int NMAX = 256;
constexpr int JT = NMAX / 32;  // key slots per lane

// Query rows warp, warp + 8, ... of one (image, head). qs/ks/vs: the head's
// q/k/v rows, ld bytes apart; out: the head's output row 0, rows out_ld bytes
// apart. scal: rq, s_attn, ro, x0_int, b_int, c_int.
template <bool LIS>
__device__ __forceinline__ void attend_rows(const int8_t* qs, const int8_t* ks, const int8_t* vs, int ld,
                                            int N, const float* __restrict__ scal, int8_t* out,
                                            size_t out_ld) {
  const float rq = scal[0], s_attn = scal[1], ro = scal[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < N; i += kThreads / 32) {
    uint32_t qv[D / 4];
#pragma unroll
    for (int u = 0; u < D / 4; ++u) qv[u] = ld32(qs + i * ld + 4 * u);

    float ac[JT];
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      ac[t] = 0.f;
      if (j < N) {
        int s = 0;
#pragma unroll
        for (int u = 0; u < D / 4; ++u)
          s = __dp4a(static_cast<int>(qv[u]), static_cast<int>(ld32(ks + j * ld + 4 * u)), s);
        ac[t] = requant(__fmul_rn(__int2float_rn(s), rq), -128.f, 127.f);
      }
    }

    float o0, o1;
    if constexpr (LIS) {
      int wt[JT];
      lis_row<JT>(ac, N, scal[3], scal[4], scal[5], wt);
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
      softmax_row<JT>(ac, N, s_attn, p);
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
    o.x = to_i8(requant(o0, -128.f, 127.f));
    o.y = to_i8(requant(o1, -128.f, 127.f));
    *reinterpret_cast<char2*>(out + i * out_ld + 2 * lane) = o;
  }
}

// One (outer, head) item: copy the head's q/k/v rows, row i at
// {q,k,v} + outer·in_outer + head·D + i·in_ld, into smem (3·N·QROW bytes),
// then attend_rows into out + outer·out_outer + head·D, rows out_ld apart.
template <bool LIS>
__device__ __forceinline__ void attention_item(const int8_t* q, const int8_t* k, const int8_t* v, int in_ld,
                                               size_t in_outer, const float* scal, int8_t* out, int out_ld,
                                               size_t out_outer, int N, int H, int item, int8_t* smem) {
  const int outer = item / H, head = item % H;
  const size_t off = outer * in_outer + head * D;
  for (int idx = threadIdx.x; idx < 3 * N * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), u = idx % (D / 4);
    const int which = r / N, i = r % N;  // which: 0 q, 1 k, 2 v
    const int8_t* src = which == 0 ? q : (which == 1 ? k : v);
    *reinterpret_cast<uint32_t*>(smem + r * QROW + 4 * u) = ld32(src + off + (size_t)i * in_ld + 4 * u);
  }
  __syncthreads();
  attend_rows<LIS>(smem, smem + N * QROW, smem + 2 * N * QROW, QROW, N, scal,
                   out + outer * out_outer + head * D, out_ld);
}

}  // namespace vit_attn
}  // namespace p2v
