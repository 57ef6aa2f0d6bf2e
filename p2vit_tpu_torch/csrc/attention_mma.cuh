// Per-tile bodies of the int8 attention kernels on mma.sync: the ViT
// cluster kernel (csrc/attention_lis.cu, p2v_lis_attention_qkv_fused: one
// (image, head) of head_dim 64 or 128, its query rows split across a
// cluster of ceil(N/64) CTAs), the ViT per-item body of the other two ViT
// kernels and the fused encoder layer (attention_rows.cuh: one (image,
// head) item of head_dim ≤ 128 per CTA) and the Swin windowed kernel
// (csrc/swin_attention.cu: (window, head) items of head_dim 32 or 64,
// N ≤ 256). NW, where a body takes it, is the block's warps (8 but in the
// fused layer's 12-warp block).
//
// * QkvPlan (vit_attn): the cluster size, each CTA's 16-row query groups and
//   the shared-memory layout (ops/attention_lis.py qkv_cluster_plan mirrors it).
// * scores_mma<HD>: q·kᵀ of 16-row query groups against every key on
//   mma.sync m16n8k32 s8·s8 (|q·k| ≤ HD·128² < 2^20 for HD ≤ 64: exact
//   int32 in any order, so equal to a dp4a sum); the caller's epilogue gets
//   each pair of adjacent scores (ViT: clip(round(acc·rq)) into an int8
//   score tile; Swin: that, the relative-position bias and the qact2
//   requant).
// * lis_weight_rows<JT>: one warp per query row reads its scores (the
//   caller's loader) into the lane layout of p2v::lis_row (common.cuh,
//   unchanged), and writes each weight w = 2^(15−q) ∈ {0, 1, …, 2^15} as two
//   u8 planes hi = w >> 8, lo = w & 0xFF (both ≤ 128); the hi plane may lie
//   over an int8 score tile (each lane writes only the bytes it read).
// * av_mma_to<HD> (av_mma: its two-byte-store form): attn@v as
//   256·(hi·V) + lo·V on mma.sync m16n8k32 u8·s8
//   against V transposed (d × keys, keys contiguous: the col B operand).
//   lis_weight gives w_j ≤ 1.5·2^15/round(Σe/e_j): at most 2^16·e_j/Σe
//   where e_j ≤ Σe/2, and 1.5·2^15 for the one key a row may have above
//   it, so Σ_j w_j ≤ 3.5·2^15 at ANY N. Hence |av_int| = |Σ_j w_j·v_j| ≤
//   3.5·2^22 < 2^24, and each plane's sum (hi_j, lo_j ≤ w_j) stays below
//   2^24 too: av_int is the exact integer Σ_j w_j·v_j, exact in float32,
//   the scalar shift-accumulate's bit for bit; out =
//   clip(round(av_int·2^-15·ro)).
// * lis_weight_rows_wide, softmax_av_wide: the same rows past NMAX keys
//   (or at head_dim 128), where a row's scores no longer fit a lane's JT
//   registers: each pass re-reads the row from the caller's key(r, j)
//   (the score plane) and recomputes each key's int-exp or exp, op for op
//   as the register forms do, so the two give the same bits.
// * softmax_av_to (softmax_av_rows: its head_dim-64, two-byte-store form;
//   LIS off, head_dim 32 or 64, R rows a warp side by side):
//   p2v::softmax_row and the float64 Σ_j p_j·v_j in key order, on the
//   caller's scores and row-major V: each product is exact, so each fma
//   rounds as a multiply-then-add, and v reaches float64 by integer ops and
//   a DADD. (The Swin kernel sums
//   its LIS-off rows itself, over v codes it converts to float64 once per
//   item.)
//
// Warps take (16-row group, 8-column tile) pairs in turn in both products.
// Keys past N carry weight 0 and zero q/k/v codes (padded to a multiple of
// 32), never garbage. Output codes go through the caller's out_row(row) or,
// in the *_to forms, its store(row, col, code, code of col + 1).
#pragma once

#include "common.cuh"

namespace p2v {
namespace vit_attn {

constexpr int NMAX = 256;       // tokens a row of JT register slots holds; past it the *_wide forms
constexpr int JT = NMAX / 32;   // key slots per lane of a score row
constexpr int MAX_CLUSTER = 16; // CTAs a cluster may hold on the H100 (past 8: the non-portable size)

}  // namespace vit_attn

namespace mma_attn {

constexpr int QGROUP = 16;  // query rows per MMA row tile

// Scores of ng query groups (q rows qm + r·ld) against keys [0, nk) (k
// rows ka + j·ld; nk a multiple of 8), head_dim HD. epi(r, j, acc_j,
// acc_j+1) takes the scores of row r at keys j and j + 1.
template <int HD, int NW = kThreads / 32, class Epi>
__device__ __forceinline__ void scores_mma(const int8_t* qm, const int8_t* ka, int ld, int ng, int nk,
                                           Epi&& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int ntn = nk / 8;
  for (int p = warp; p < ng * ntn; p += NW) {
    const int r0 = (p / ntn) * QGROUP, n0 = (p % ntn) * 8;
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < HD; kk += 32) {
      const int8_t* qa = qm + (r0 + g) * ld + kk + 4 * t;
      const int8_t* kb = ka + (n0 + g) * ld + kk + 4 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 16), ld32(qa + 8 * ld + 16)};
      const uint32_t b[2] = {ld32(kb), ld32(kb + 16)};
      mma_s8(c, a, b);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) epi(r0 + g + 8 * h, n0 + 2 * t, c[2 * h], c[2 * h + 1]);
  }
}

// The attention code clip(round(acc·rq)) of an int32 score.
__device__ __forceinline__ float score_code(int acc, float rq) {
  return requant(__fmul_rn(__int2float_rn(acc), rq), -128.f, 127.f);
}

// A warp's int8 score row (codes s[j], j < n) in lis_row's lane layout.
template <int JT>
__device__ __forceinline__ void load_scores(const int8_t* s, int n, float (&ac)[JT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    const int j = lane + 32 * t;
    ac[t] = j < n ? static_cast<float>(s[j]) : 0.f;
  }
}

// LIS weights of query rows r = 0 … nrows−1 (global row row0 + r; rows
// ≥ n get weight 0): load(r, ac) gives row r's scores in lis_row's lane
// layout → hi plane hi[r·ld + j], lo plane lo[r·ld + j], keys j < kpad.
template <int JT, int NW = kThreads / 32, class Load>
__device__ __forceinline__ void lis_weight_rows(Load&& load, int8_t* hi, int8_t* lo, int ld, int nrows, int row0,
                                                int n, int kpad, float x0, float b_int, float c_int) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += NW) {
    int wt[JT];
    if (row0 + r < n) {
      float ac[JT];
      load(r, ac);
      lis_row<JT>(ac, n, x0, b_int, c_int, wt);
    } else {
#pragma unroll
      for (int t = 0; t < JT; ++t) wt[t] = 0;
    }
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < kpad) {
        reinterpret_cast<uint8_t*>(hi)[r * ld + j] = static_cast<uint8_t>(wt[t] >> 8);
        reinterpret_cast<uint8_t*>(lo)[r * ld + j] = static_cast<uint8_t>(wt[t] & 0xFF);
      }
    }
  }
}

// lis_weight_rows past NMAX keys: key(r, j) gives row r's score at key j
// (j < n), read again by each pass (the row maximum, the exp_sum limbs,
// the weights); the int-exp is recomputed in the last pass, so no row
// lives in registers. A lane reads and then overwrites only its own keys'
// bytes, so the hi plane may lie over the score tile as above.
template <int NW = kThreads / 32, class Key>
__device__ __forceinline__ void lis_weight_rows_wide(Key&& key, int8_t* hi, int8_t* lo, int ld, int nrows, int row0,
                                                     int n, int kpad, float x0, float b_int, float c_int) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float xmin = __fmul_rn(32.f, x0);
  for (int r = warp; r < nrows; r += NW) {
    const bool live = row0 + r < n;  // the same for the whole warp
    float mx = __int_as_float(0xff800000), esum = 0.f;
    if (live) {
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, key(r, j));
      mx = warp_max(mx);
      long long shi = 0, slo = 0;
      for (int j = lane; j < n; j += 32) add_limbs(lis_exp(key(r, j), mx, xmin, x0, b_int, c_int), shi, slo);
      esum = limbs_f32(warp_sum(shi), warp_sum(slo));
    }
    for (int j = lane; j < kpad; j += 32) {
      const int w = live && j < n ? lis_weight(esum, lis_exp(key(r, j), mx, xmin, x0, b_int, c_int)) : 0;
      reinterpret_cast<uint8_t*>(hi)[r * ld + j] = static_cast<uint8_t>(w >> 8);
      reinterpret_cast<uint8_t*>(lo)[r * ld + j] = static_cast<uint8_t>(w & 0xFF);
    }
  }
}

// attn@v of ng query groups, head_dim HD: weight planes hi/lo (row r at
// r·ld) against V transposed (dim d at vt + d·ld), keys [0, kpad). Warps
// take (group, 8-dim tile) pairs in turn (HD = 64 on 8 warps: warp w owns
// dims [8w, 8w + 8) of every group). The codes of output row r (global row
// row0 + r < n) at dims col, col + 1 go to store(row0 + r, col, c0, c1).
template <int HD, int NW = kThreads / 32, class Store>
__device__ __forceinline__ void av_mma_to(const int8_t* hi, const int8_t* lo, const int8_t* vt, int ld, int ng,
                                          int kpad, int row0, int n, float ro, Store&& store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  constexpr int NT = HD / 8;        // 8-dim tiles
  constexpr bool ONE = NT == NW;    // one dim tile per warp, every group in turn
  for (int p = ONE ? 0 : warp; p < (ONE ? ng : ng * NT); p += ONE ? 1 : NW) {
    const int r0 = (ONE ? p : p / NT) * QGROUP, n0 = (ONE ? warp : p % NT) * 8;
    int ch[4] = {0, 0, 0, 0}, cl[4] = {0, 0, 0, 0};
    for (int kk = 0; kk < kpad; kk += 32) {
      const int8_t* ah = hi + (r0 + g) * ld + kk + 4 * t;
      const int8_t* al = lo + (r0 + g) * ld + kk + 4 * t;
      const int8_t* vb = vt + (n0 + g) * ld + kk + 4 * t;
      const uint32_t a_hi[4] = {ld32(ah), ld32(ah + 8 * ld), ld32(ah + 16), ld32(ah + 8 * ld + 16)};
      const uint32_t a_lo[4] = {ld32(al), ld32(al + 8 * ld), ld32(al + 16), ld32(al + 8 * ld + 16)};
      const uint32_t b[2] = {ld32(vb), ld32(vb + 16)};
      mma_u8s8(ch, a_hi, b);
      mma_u8s8(cl, a_lo, b);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r0 + g + 8 * h;
      if (row >= n) continue;
      const int a0 = ch[2 * h] * 256 + cl[2 * h], a1 = ch[2 * h + 1] * 256 + cl[2 * h + 1];
      store(row, n0 + 2 * t, to_i8(requant(__fmul_rn(__fmul_rn(__int2float_rn(a0), 0x1p-15f), ro), -128.f, 127.f)),
            to_i8(requant(__fmul_rn(__fmul_rn(__int2float_rn(a1), 0x1p-15f), ro), -128.f, 127.f)));
    }
  }
}

// av_mma_to with output row r's codes at out_row(r) + col, two bytes at a time.
template <int HD, class OutRow>
__device__ __forceinline__ void av_mma(const int8_t* hi, const int8_t* lo, const int8_t* vt, int ld, int ng,
                                       int kpad, int row0, int n, float ro, OutRow&& out_row) {
  av_mma_to<HD>(hi, lo, vt, ld, ng, kpad, row0, n, ro, [&](int row, int col, int8_t c0, int8_t c1) {
    char2 o;
    o.x = c0;
    o.y = c1;
    *reinterpret_cast<char2*>(out_row(row) + col) = o;
  });
}

// The exact double of an int8 code given as its byte: 2^52 + (byte ^ 0x80)
// is exact, and so is subtracting 2^52 + 128 (an integer add and a DADD, not
// a quarter-rate int → double conversion).
__device__ __forceinline__ double i8_to_f64(uint32_t byte) {
  return __dsub_rn(__hiloint2double(0x43300000, static_cast<int>((byte & 0xFFu) ^ 0x80u)), 4503599627370624.0);
}

// LIS off: query rows r < nrows with global row row0 + r < n: load(r, ac)
// → p2v::softmax_row at scale s_attn → Σ_j p_j·v_j in float64 over
// row-major v rows (v + j·vld, zeros from n to the next multiple of 32),
// keys in order; lane l owns dims 2l and 2l + 1 (HD = 64) or dim l (HD =
// 32). Each product p_j·v_j is exact in float64 (24 + 8 bits), so
// fma(p_j, v_j, a) rounds exactly as a + p_j·v_j; p_j goes to double once,
// by the lane that holds it. A warp sums R rows side by side (rows r,
// r + NW, …: independent chains, each in key order; v converted once for
// all). Codes of dims col, col + 1 of output row row0 + r go to
// store(row0 + r, col, c0, c1).
template <int JT, int HD = 64, int NW = kThreads / 32, int R = 1, class Load, class Store>
__device__ __forceinline__ void softmax_av_to(Load&& load, const int8_t* v, int vld, int nrows, int row0, int n,
                                              float s_attn, float ro, Store&& store) {
  static_assert(HD == 32 || HD == 64, "a lane owns one or two dims");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows && row0 + r < n; r += R * NW) {
    bool has[R];
    float p[R][JT];
    double a0[R], a1[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int rk = r + k * NW;
      has[k] = k == 0 || (rk < nrows && row0 + rk < n);  // a missing row reruns row r, dropped
      float ac[JT];
      load(has[k] ? rk : r, ac);
      softmax_row<JT>(ac, n, s_attn, p[k]);
      a0[k] = 0.0, a1[k] = 0.0;
    }
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      if (32 * t >= n) break;
      // keys 32t … 32t + 31, unrolled: past n, p = 0 and the v rows are
      // zeros, and a + (+0) = a (a is never −0)
      double pt[R];
#pragma unroll
      for (int k = 0; k < R; ++k) pt[k] = static_cast<double>(p[k][t]);
      const int8_t* vt = v + 32 * t * vld + (HD / 32) * lane;
#pragma unroll
      for (int src = 0; src < 32; ++src) {
        if constexpr (HD == 64) {
          const uint32_t v2 = *reinterpret_cast<const uint16_t*>(vt + src * vld);
          const double v0 = i8_to_f64(v2), v1 = i8_to_f64(v2 >> 8);
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const double pj = __shfl_sync(0xffffffffu, pt[k], src);
            a0[k] = __fma_rn(pj, v0, a0[k]);
            a1[k] = __fma_rn(pj, v1, a1[k]);
          }
        } else {
          const double v0 = i8_to_f64(*reinterpret_cast<const uint8_t*>(vt + src * vld));
#pragma unroll
          for (int k = 0; k < R; ++k) a0[k] = __fma_rn(__shfl_sync(0xffffffffu, pt[k], src), v0, a0[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int8_t c0 = to_i8(requant(__fmul_rn(__double2float_rn(a0[k]), ro), -128.f, 127.f));
      if constexpr (HD == 64) {
        if (has[k])
          store(row0 + r + k * NW, 2 * lane, c0, to_i8(requant(__fmul_rn(__double2float_rn(a1[k]), ro), -128.f, 127.f)));
      } else {  // lane l's code and lane l + 1's, stored by the even lane
        const int8_t c1 = static_cast<int8_t>(__shfl_down_sync(0xffffffffu, static_cast<int>(c0), 1));
        if (has[k] && (lane & 1) == 0) store(row0 + r + k * NW, lane, c0, c1);
      }
    }
  }
}

// softmax_av_to at head_dim 64 with output row r's codes at out_row(r) + col.
template <int JT, class Load, class OutRow>
__device__ __forceinline__ void softmax_av_rows(Load&& load, const int8_t* v, int vld, int nrows, int row0, int n,
                                                float s_attn, float ro, OutRow&& out_row) {
  softmax_av_to<JT>(load, v, vld, nrows, row0, n, s_attn, ro, [&](int row, int col, int8_t c0, int8_t c1) {
    char2 o;
    o.x = c0;
    o.y = c1;
    *reinterpret_cast<char2*>(out_row(row) + col) = o;
  });
}

// The LIS-off e_j of softmax_row: exp(code·s − mx) through float64,
// rounded once.
__device__ __forceinline__ float softmax_e(float code, float s, float mx) {
  return static_cast<float>(exp(static_cast<double>(__fsub_rn(__fmul_rn(code, s), mx))));
}

// softmax_av_to past NMAX keys or at head_dim HD = 128, one row a warp at a
// time: key(r, j) gives row r's score code at key j (j < n), read again by
// each pass (the row maximum, the float64 row sum in softmax_row's lane
// order, then attn@v), and p_j = e_j / S recomputed for each 32-key chunk,
// so the sums and their order are softmax_av_to's; lane l owns dims
// (HD/32)·l … (HD/32)·l + HD/32 − 1.
template <int HD, int NW = kThreads / 32, class Key, class Store>
__device__ __forceinline__ void softmax_av_wide(Key&& key, const int8_t* v, int vld, int nrows, int row0, int n,
                                                float s_attn, float ro, Store&& store) {
  static_assert(HD == 32 || HD == 64 || HD == 128, "a lane owns one, two or four dims");
  constexpr int DL = HD / 32;  // dims a lane owns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows && row0 + r < n; r += NW) {
    float mx = __int_as_float(0xff800000);
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, __fmul_rn(key(r, j), s_attn));
    mx = warp_max(mx);
    double sum = 0.0;
    for (int j = lane; j < n; j += 32) sum = __dadd_rn(sum, static_cast<double>(softmax_e(key(r, j), s_attn, mx)));
    const float S = __double2float_rn(warp_sum(sum));
    double a[DL];
#pragma unroll
    for (int d = 0; d < DL; ++d) a[d] = 0.0;
    for (int t = 0; 32 * t < n; ++t) {
      const int j = 32 * t + lane;
      const double pt = j < n ? static_cast<double>(__fdiv_rn(softmax_e(key(r, j), s_attn, mx), S)) : 0.0;
      const int8_t* vt = v + 32 * t * vld + DL * lane;
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        const double pj = __shfl_sync(0xffffffffu, pt, src);
        uint32_t vb;
        if constexpr (DL == 4)
          vb = *reinterpret_cast<const uint32_t*>(vt + src * vld);
        else if constexpr (DL == 2)
          vb = *reinterpret_cast<const uint16_t*>(vt + src * vld);
        else
          vb = *reinterpret_cast<const uint8_t*>(vt + src * vld);
#pragma unroll
        for (int d = 0; d < DL; ++d) a[d] = __fma_rn(pj, i8_to_f64(vb >> (8 * d)), a[d]);
      }
    }
    int8_t c[DL];
#pragma unroll
    for (int d = 0; d < DL; ++d) c[d] = to_i8(requant(__fmul_rn(__double2float_rn(a[d]), ro), -128.f, 127.f));
    if constexpr (DL == 1) {  // lane l's code and lane l + 1's, stored by the even lane
      const int8_t c1 = static_cast<int8_t>(__shfl_down_sync(0xffffffffu, static_cast<int>(c[0]), 1));
      if ((lane & 1) == 0) store(row0 + r, lane, c[0], c1);
    } else {
#pragma unroll
      for (int d = 0; d < DL; d += 2) store(row0 + r, DL * lane + d, c[d], c[d + 1]);
    }
  }
}

}  // namespace mma_attn

namespace vit_attn {

using mma_attn::QGROUP;
constexpr int ROWS_PER_CTA = 64;  // token rows whose q/k/v codes a CTA computes
// bytes per K / q row in the gathered tiles at head_dim HD (conflict-free fragments)
template <int HD>
constexpr int kld = HD + 16;
template <int HD>
constexpr int own_bytes = 3 * ROWS_PER_CTA * HD;  // a CTA's own q, k, v tiles (HD-byte rows)

// The launch plan for N tokens. Byte offsets into dynamic shared memory;
// the same in every CTA of a cluster, so a peer's tile lies at the same
// offset of its shared memory.
struct QkvPlan {
  int cs;       // CTAs per cluster, ceil(N/64) ≤ MAX_CLUSTER
  int groups;   // 16-row query groups, ceil(N/16)
  int kpad;     // keys padded to a multiple of 32 (the MMA depth)
  int vld;      // kpad + 16: bytes per row of V transposed, the scores and the weight planes
  int rows;     // query rows of the CTA with the most groups: 16·ceil(groups/cs)
  int k_all, v_all, q_mine, w_hi, w_lo, smem;

  // first group and number of groups of CTA r: 16-row groups balanced
  // across the cluster (13 groups at N = 197 split 4/3/3/3)
  __host__ __device__ int first_group(int r) const {
    return r * (groups / cs) + (r < groups % cs ? r : groups % cs);
  }
  __host__ __device__ int n_groups(int r) const { return groups / cs + (r < groups % cs ? 1 : 0); }
};

template <int HD, int GEMM_BYTES>
__host__ __device__ inline QkvPlan qkv_plan(int n) {
  QkvPlan p;
  p.cs = (n + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  p.groups = (n + QGROUP - 1) / QGROUP;
  p.kpad = (n + 31) / 32 * 32;
  p.vld = p.kpad + 16;
  p.rows = QGROUP * ((p.groups + p.cs - 1) / p.cs);
  p.k_all = own_bytes<HD>;  // the own tiles [0, own_bytes) overlay the GEMM's stages
  p.v_all = p.k_all + p.kpad * kld<HD>;
  p.q_mine = p.v_all + HD * p.vld;
  p.w_hi = p.q_mine + p.rows * kld<HD>;  // the score tile, then the hi plane
  p.w_lo = p.w_hi + p.rows * p.vld;
  const int end = p.w_lo + p.rows * p.vld;
  p.smem = end > GEMM_BYTES ? end : GEMM_BYTES;
  return p;
}

// 16-byte copies idx = 0 … total−1, four loads in flight per thread before
// their stores (the loads cross the SM-to-SM network for peer tiles).
template <class Src, class Dst>
__device__ __forceinline__ void copy16(int total, Src src, Dst dst) {
  for (int base = threadIdx.x; base < total; base += 4 * kThreads) {
    int4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + u * kThreads < total) v[u] = *reinterpret_cast<const int4*>(src(base + u * kThreads));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + u * kThreads < total) *reinterpret_cast<int4*>(dst(base + u * kThreads)) = v[u];
  }
}


}  // namespace vit_attn
}  // namespace p2v
