// The per-item body of the ViT attention kernels over q/k/v codes in device
// memory (csrc/attention_lis.cu: p2v_lis_attention_fused over (B, N, 3C)
// qkv codes, p2v_lis_attention over split (BH, N, d) q/k/v), shared with the
// fused encoder layer's attention phase (csrc/layer_fused.cu): one (outer,
// head) item of head_dim hd ≤ 128 on attention_mma.cuh's int8 mma.sync
// bodies; N is bounded by shared memory alone (layout).
//
// * Staging (stage_item): the item's q rows (16·⌈N/16⌉ of them), k rows and
//   v rows (⌈N/32⌉·32 of them) into one stage buffer, q and k rows QLD =
//   HDP + 16 bytes apart (conflict-free fragments), v rows dense; every byte
//   past N or past hd written as a zero code, so a stage needs no clearing
//   and the zero-padded head_dim (HDP = 32, 64 or 128) and keys add
//   nothing to any integer sum. 16-byte cp.async where hd, the row stride
//   and the item's offset are multiples of 16 (every ViT width), else byte
//   loads. The caller waits for the copies (cp_async_wait) and syncs.
// * attend_item: LIS on, V transposed into vt (dim d at vt + d·VLD, keys
//   contiguous, the col B operand of attn@v); then per chunk of gc 16-row
//   query groups: scores_mma<HDP> writes clip(round(acc·rq)) codes into the
//   score plane; lis_weight_rows (p2v::lis_row unchanged) writes the hi plane
//   over it and the lo plane; av_mma_to<HDP> sums 256·(hi·V) + lo·V, the
//   exact integer Σ_j w_j·v_j, and stores clip(round(av·2^-15·ro)). LIS off:
//   softmax_av_to, p2v::softmax_row and the float64 Σ_j p_j·v_j in key
//   order over the stage's row-major v, two rows a warp side by side. WIDE
//   (N > NMAX, or HDP = 128): the rows run in attention_mma.cuh's *_wide
//   forms, which re-read each row from the score plane instead of holding
//   it in JT registers a lane, with the same arithmetic and so the same
//   bits. Output columns past hd are never
//   written: codes go out two bytes at a time where aligned, else one.
//
// Layout (ops/attention_lis.vit_attention_layout mirrors it): `stages`
// stage buffers, then (LIS) vt, then the score / hi plane and (LIS) the lo
// plane, 16·gc rows of VLD = kpad + 16 bytes each. gc < ⌈N/16⌉ trades
// barriers for shared memory.
#pragma once

#include "attention_mma.cuh"

namespace p2v {
namespace vit_item {

using vit_attn::JT;
using vit_attn::NMAX;

struct Layout {
  int hdp;     // head_dim padded to 32, 64 or 128
  int qld;     // bytes per staged q / k row
  int kpad;    // keys padded to a multiple of 32 (the MMA depth)
  int ng;      // 16-row query groups, ⌈N/16⌉
  int vld;     // bytes per row of V transposed and of the planes
  int gc;      // query groups per chunk
  int k_off;   // k rows in a stage
  int v_off;   // v rows in a stage
  int stage;   // bytes of one stage buffer
  int vt;      // V transposed (LIS)
  int s;       // the score / hi plane
  int lo;      // the lo plane (LIS)
  int total;   // bytes
};

__host__ __device__ inline int pad_hd(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

// The rows' form at N keys and padded head_dim hdp: the JT-register rows up
// to NMAX keys at HDP 32 and 64, the *_wide rows past them.
__host__ __device__ inline bool wide(int n, int hdp) { return n > NMAX || hdp > 64; }

__host__ __device__ inline Layout layout(int n, int hd, bool lis, int stages, int gc) {
  Layout l{};
  l.hdp = pad_hd(hd);
  l.qld = l.hdp + 16;
  l.kpad = (n + 31) / 32 * 32;
  l.ng = (n + 15) / 16;
  l.vld = l.kpad + 16;
  l.gc = gc;
  l.k_off = 16 * l.ng * l.qld;
  l.v_off = l.k_off + l.kpad * l.qld;
  l.stage = l.v_off + l.kpad * l.hdp;
  l.vt = stages * l.stage;
  l.s = l.vt + (lis ? l.hdp * l.vld : 0);
  l.lo = l.s + 16 * gc * l.vld;
  l.total = l.lo + (lis ? 16 * gc * l.vld : 0);
  return l;
}

// Groups per chunk within `budget` bytes: the fewest chunks that fit, their
// groups balanced (⌈ng/chunks⌉); force > 0 takes min(force, ng). 0 where
// one group does not fit.
__host__ __device__ inline int fit_gc(int n, int hd, bool lis, int stages, int budget, int force) {
  const int ng = (n + 15) / 16;
  if (force > 0) return force < ng ? force : ng;
  int most = 0;
  for (int g = ng; g >= 1 && most == 0; --g)
    if (layout(n, hd, lis, stages, g).total <= budget) most = g;
  if (most == 0) return 0;
  const int chunks = (ng + most - 1) / most;
  return (ng + chunks - 1) / chunks;
}

// Where item `item` = (outer, head) = (item / H, item % H) lives: its q/k/v
// row i at {q,k,v} + outer·in_outer + head·hd + i·in_ld; its output row i at
// out + outer·out_outer + head·hd + i·out_ld.
struct Items {
  const int8_t *q, *k, *v;
  int8_t* out;
  int in_ld, out_ld;
  size_t in_outer, out_outer;
  int N, H, hd;
  bool vec16;  // 16-byte copies: hd, in_ld and in_outer multiples of 16
};

// The item's q, k and v rows into stage buffer `st` (zeros past N and hd);
// NT threads. Commits one cp.async group.
template <int NT>
__device__ __forceinline__ void stage_item(const Layout& L, const Items& a, int item, int8_t* st) {
  const int outer = item / a.H, head = item - outer * a.H;
  const size_t off = outer * a.in_outer + (size_t)head * a.hd;
  const int cpr = L.hdp / 16, rq = 16 * L.ng;  // 16-byte chunks a row; q rows
  const int total = (rq + 2 * L.kpad) * cpr;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int r = i / cpr, c = i - r * cpr;
    const int8_t* src;
    int8_t* dst;
    int row;
    if (r < rq) {
      row = r, src = a.q, dst = st + row * L.qld;
    } else if (r < rq + L.kpad) {
      row = r - rq, src = a.k, dst = st + L.k_off + row * L.qld;
    } else {
      row = r - rq - L.kpad, src = a.v, dst = st + L.v_off + row * L.hdp;
    }
    dst += 16 * c;
    if (row < a.N && 16 * c < a.hd) {
      src += off + (size_t)row * a.in_ld + 16 * c;
      if (a.vec16) {
        cp_async16(dst, src);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          w[u] = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (16 * c + 4 * u + e < a.hd)
              w[u] |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * u + e])) << (8 * e);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// Attention of the item staged in `st` (landed and synced); `sm`: the
// layout's base (vt and the planes). NT threads, NW = NT/32 warps. scal:
// rq, s_attn, ro, x0_int, b_int, c_int. WIDE = wide(N, HDP). Ends with
// __syncthreads.
template <bool LIS, int HDP, int NT, bool WIDE>
__device__ __forceinline__ void attend_item(const Layout& L, const Items& a, int item, const int8_t* st, int8_t* sm,
                                            const float* __restrict__ scal) {
  namespace ma = mma_attn;
  constexpr int NW = NT / 32;
  const int outer = item / a.H, head = item - outer * a.H;
  int8_t* ob = a.out + outer * a.out_outer + (size_t)head * a.hd;
  const bool pairs = (a.out_ld & 1) == 0 && (reinterpret_cast<uintptr_t>(ob) & 1) == 0;
  const int hd = a.hd, out_ld = a.out_ld, N = a.N;
  auto store = [&](int row, int col, int8_t c0, int8_t c1) {
    int8_t* p = ob + (size_t)row * out_ld + col;
    if (pairs && col + 1 < hd) {
      char2 o;
      o.x = c0;
      o.y = c1;
      *reinterpret_cast<char2*>(p) = o;
    } else {
      if (col < hd) p[0] = c0;
      if (col + 1 < hd) p[1] = c1;
    }
  };
  const int8_t* qs = st;
  const int8_t* ks = st + L.k_off;
  const int8_t* vs = st + L.v_off;
  int8_t* vt = sm + L.vt;
  int8_t* s = sm + L.s;
  const float rq = scal[0];
  if constexpr (LIS) {
    // V transposed: thread (d, 8-key group) moves 8 keys of dim d
    for (int i = threadIdx.x; i < HDP * (L.kpad / 8); i += NT) {
      const int d = i % HDP, j8 = i / HDP;
      uint32_t w[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(vs[(8 * j8 + e) * HDP + d])) << (8 * (e & 3));
      *reinterpret_cast<uint2*>(vt + d * L.vld + 8 * j8) = make_uint2(w[0], w[1]);
    }
    __syncthreads();
  }
  for (int g0 = 0; g0 < L.ng; g0 += L.gc) {
    const int ngc = min(L.gc, L.ng - g0), row0 = 16 * g0;
    ma::scores_mma<HDP, NW>(qs + row0 * L.qld, ks, L.qld, ngc, L.kpad, [&](int r, int j, int a0, int a1) {
      char2 c;
      c.x = to_i8(ma::score_code(a0, rq));
      c.y = to_i8(ma::score_code(a1, rq));
      *reinterpret_cast<char2*>(s + r * L.vld + j) = c;
    });
    __syncthreads();
    auto load = [&](int r, float(&ac)[JT]) { ma::load_scores<JT>(s + r * L.vld, N, ac); };
    auto key = [&](int r, int j) { return static_cast<float>(s[r * L.vld + j]); };
    if constexpr (LIS) {
      if constexpr (WIDE)
        ma::lis_weight_rows_wide<NW>(key, s, sm + L.lo, L.vld, 16 * ngc, row0, N, L.kpad, scal[3], scal[4], scal[5]);
      else
        ma::lis_weight_rows<JT, NW>(load, s, sm + L.lo, L.vld, 16 * ngc, row0, N, L.kpad, scal[3], scal[4],
                                    scal[5]);
      __syncthreads();
      ma::av_mma_to<HDP, NW>(s, sm + L.lo, vt, L.vld, ngc, L.kpad, row0, N, scal[2], store);
    } else if constexpr (WIDE) {
      ma::softmax_av_wide<HDP, NW>(key, vs, HDP, 16 * ngc, row0, N, scal[1], scal[2], store);
    } else {
      ma::softmax_av_to<JT, HDP, NW, 2>(load, vs, HDP, 16 * ngc, row0, N, scal[1], scal[2], store);
    }
    __syncthreads();  // the planes are rewritten by the next chunk or item
  }
}

}  // namespace vit_item
}  // namespace p2v
