// int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax, for ViT
// (ops/attention_lis.py): the qkv-fused kernel at head_dim 64 or 128 (its
// wrapper zero-pads smaller heads to 64), the other two at any head_dim
// their wrappers take (≤ 128).
//
// * p2v_lis_attention_qkv_fused replaces the Pallas kernel
//   p2vit_tpu/ops/attention_lis.py:lis_attention_qkv_fused (_qkv_fused_kernel
//   -> heads_attention): qkv projection and attention, the qkv codes kept on
//   chip. One thread-block cluster per (image, head), ceil(N/64) CTAs (at
//   most 16, N ≤ 1024; past 8 with the non-portable cluster size; shared
//   memory binds first: N ≤ 768 at HD 64, N ≤ 480 at HD 128), via
//   cudaLaunchKernelEx with a cluster dimension, the per-tile bodies in
//   attention_mma.cuh:
//   1. CTA r computes the head's q, k and v codes of token rows
//      [64r, 64r + 64) as one Gemm<64, 3·HD> tile of the image's (N, Cin)
//      codes against the gathered weight rows {q, k, v}·C + head·HD + dd,
//      requantized to int8 into its own shared memory (rows ≥ N are zeros;
//      v stored transposed with LIS on).
//   2. cluster.sync(); each CTA copies the whole head's K and V (V
//      transposed: the col B operand of attn@v) and the q rows of its
//      16-row query groups out of its peers' shared memory (distributed
//      shared memory, map_shared_rank), once, into local tiles; then
//      cluster.sync() again, after which no CTA reads a peer's memory, so
//      each may finish and exit on its own. No k/v row goes through HBM
//      and none is computed twice.
//   3. The CTA's query groups (ceil(N/16) groups balanced across the
//      cluster: 4/3/3/3 at N = 197) attend: q·kᵀ on int8 mma.sync into a
//      score tile, p2v::lis_row per row (one warp a row), and attn@v on
//      u8·s8 mma.sync over the weights' hi/lo byte planes; LIS off:
//      p2v::softmax_row and the float64 Σ_j p_j·v_j per row.
//   The GEMM's stage buffers hold the own tiles afterwards; about 81 KB of
//   shared memory per CTA at N = 197 and __launch_bounds__(256, 2) give two
//   CTAs per SM. What bounds it on the H100 (one CTA's phases at DeiT-S
//   shapes): the per-row LIS chain (two IEEE divides per score, int64 limb
//   sums, three warp reductions), about half of a CTA's time, and the qkv
//   GEMM on mma.sync, about a third; the two tensor-core products and the
//   peer copy take the rest. LIS off: the scalar float64 attn@v.
// * p2v_lis_attention_fused replaces lis_attention_fused (_fused_kernel ->
//   heads_attention): (image, head) items over the (B, N, 3C) qkv codes,
//   head_dim 1, 2, 4, 8, 16, 32 or 64 (the divisors of 128 up to 64).
// * p2v_lis_attention replaces lis_attention (_kernel): (batch·head) items
//   over split (BH, N, d) q, k and v, any head_dim d ≤ 64.
//
// The last two run one item per CTA on the per-item body of
// attention_rows.cuh (shared with the fused encoder layer): the item's q,
// k and v rows staged by cp.async with keys and head_dim zero-padded, q·kᵀ
// on int8 mma.sync into a score plane, p2v::lis_row per row into the hi/lo
// weight planes and attn@v on u8·s8 mma.sync against V transposed; LIS off:
// p2v::softmax_row and the float64 Σ_j p_j·v_j in key order. The plan
// (vit_attention_plan in ops/attention_lis.py mirrors it) takes the query
// groups in chunks of gc, sized so that as many CTAs as shared memory allows
// (up to 4) share an SM: their warps hide the LIS chain's latency, which
// the chunks' extra barriers cost less than. Bound: the bytes of q/k/v in and codes out;
// the kernels are bound by the per-row LIS chain (two IEEE divides and an
// int-exp per score), which the SMs must issue; LIS off by the float64
// attn@v.
#include <cooperative_groups.h>

#include "attention_rows.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace p2v::vit_attn;

// The cluster kernel's qkv GEMM at head_dim HD: one 64 × 3·HD tile.
template <int HD>
using GemmOf = p2v::Gemm<ROWS_PER_CTA, 3 * HD, 2, 4>;
static_assert(GemmOf<64>::SMEM_BYTES >= own_bytes<64> && GemmOf<128>::SMEM_BYTES >= own_bytes<128>,
              "the own tiles overlay the GEMM's stages");

template <int HD>
__host__ __device__ inline QkvPlan plan_of(int N) {
  return qkv_plan<HD, GemmOf<HD>::SMEM_BYTES>(N);
}

// WIDE: the rows past NMAX keys (and every row at HD = 128) in the *_wide
// forms (attention_mma.cuh).
template <bool LIS, int HD, bool WIDE>
__global__ void __launch_bounds__(p2v::kThreads, HD == 64 ? 2 : 1)
    lis_attention_qkv_kernel(const int8_t* __restrict__ h, const int8_t* __restrict__ w,
                             const float* __restrict__ r, const float* __restrict__ bvec,
                             const float* __restrict__ scal, int8_t* __restrict__ out, int N,
                             int Cin, int C, int H, unsigned long long* __restrict__ stamps) {
  using G = GemmOf<HD>;
  constexpr int KLD = kld<HD>, CPR = HD / 16;  // gathered row pitch; 16-byte chunks an own-tile row
  extern __shared__ __align__(16) int8_t dsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const QkvPlan P = plan_of<HD>(N);
  // the stamped CTA: rank 0 of the middle cluster, in the launch's steady state
  const bool stamper = stamps != nullptr && threadIdx.x == 0 && blockIdx.x == gridDim.x / P.cs / 2 * P.cs;
  auto stamp = [&](int i) {
    if (stamper)
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(stamps[i]));
  };
  stamp(0);
  const int rank = static_cast<int>(cluster.block_rank());
  const int item = blockIdx.x / P.cs, img = item / H, head = item % H;
  const int m0 = rank * ROWS_PER_CTA;
  int8_t* own_q = dsmem;
  int8_t* own_k = dsmem + ROWS_PER_CTA * HD;
  int8_t* own_v = dsmem + 2 * ROWS_PER_CTA * HD;

  // 1. q/k/v codes of token rows [m0, m0 + 64) into the own tiles
  {
    const int8_t* hb = h + (size_t)img * N * Cin;
    int acc[G::MT][G::NT][4];
    G::run([&](int rr) -> const int8_t* { return m0 + rr < N ? hb + (size_t)(m0 + rr) * Cin : nullptr; },
           [&](int rr) -> const int8_t* {
             return w + (size_t)((rr / HD) * C + head * HD + rr % HD) * Cin;
           },
           Cin, dsmem, acc);
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = G::row_of(i, e), col = G::col_of(j, e);
          const int which = col / HD, dd = col % HD, gn = which * C + head * HD + dd;
          const int8_t code =
              m0 + row < N ? p2v::to_i8(p2v::requant(
                                 __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), r[gn]), bvec[gn]),
                                 -128.f, 127.f))
                           : int8_t(0);
          if (which == 0)
            own_q[row * HD + dd] = code;
          else if (which == 1)
            own_k[row * HD + dd] = code;
          else
            own_v[LIS ? dd * ROWS_PER_CTA + row : row * HD + dd] = code;
        }
  }
  cluster.sync();
  stamp(1);

  // 2. the head's K and V and this CTA's q rows, out of the peers' tiles
  const int g0 = P.first_group(rank), ng = P.n_groups(rank), row0 = g0 * QGROUP, nrows = ng * QGROUP;
  int8_t* k_all = dsmem + P.k_all;
  int8_t* v_all = dsmem + P.v_all;
  int8_t* q_mine = dsmem + P.q_mine;
  // n rows of HD bytes from row `first` on (row j in peer j/64's tile) into dst, ld bytes apart
  auto gather_rows = [&](int8_t* own, int first, int n, int8_t* dst, int ld) {
    copy16(n * CPR,
           [&](int i) {
             const int row = first + i / CPR;
             return cluster.map_shared_rank(own, row / ROWS_PER_CTA) + (row % ROWS_PER_CTA) * HD + 16 * (i % CPR);
           },
           [&](int i) { return dst + (i / CPR) * ld + 16 * (i % CPR); });
  };
  gather_rows(own_k, 0, P.kpad, k_all, KLD);
  if constexpr (LIS) {
    const int kq = P.kpad / 16;  // 16-key chunks of a row of V^T, 4 from each peer
    copy16(HD * kq,
           [&](int i) {
             const int c = i % kq;
             return cluster.map_shared_rank(own_v, c >> 2) + (i / kq) * ROWS_PER_CTA + 16 * (c & 3);
           },
           [&](int i) { return v_all + (i / kq) * P.vld + 16 * (i % kq); });
  } else {
    gather_rows(own_v, 0, P.kpad, v_all, HD);
  }
  gather_rows(own_q, row0, nrows, q_mine, KLD);
  cluster.sync();  // the last read of a peer's shared memory is done
  stamp(2);

  // 3. attention of this CTA's query groups
  namespace ma = p2v::mma_attn;
  int8_t* s = dsmem + P.w_hi;
  int8_t* o = out + (size_t)img * N * C + head * HD;
  const float rq = scal[0];
  ma::scores_mma<HD>(q_mine, k_all, KLD, ng, P.kpad, [&](int r, int j, int a0, int a1) {
    char2 c;
    c.x = p2v::to_i8(ma::score_code(a0, rq));
    c.y = p2v::to_i8(ma::score_code(a1, rq));
    *reinterpret_cast<char2*>(s + r * P.vld + j) = c;
  });
  __syncthreads();
  stamp(3);
  auto load = [&](int r, float(&ac)[JT]) { ma::load_scores<JT>(s + r * P.vld, N, ac); };
  auto key = [&](int r, int j) { return static_cast<float>(s[r * P.vld + j]); };
  auto out_row = [&](int row) { return o + (size_t)row * C; };
  if constexpr (LIS) {
    if constexpr (WIDE)
      ma::lis_weight_rows_wide(key, s, dsmem + P.w_lo, P.vld, nrows, row0, N, P.kpad, scal[3], scal[4], scal[5]);
    else
      ma::lis_weight_rows<JT>(load, s, dsmem + P.w_lo, P.vld, nrows, row0, N, P.kpad, scal[3], scal[4], scal[5]);
    __syncthreads();
    stamp(4);
    ma::av_mma<HD>(s, dsmem + P.w_lo, v_all, P.vld, ng, P.kpad, row0, N, scal[2], out_row);
  } else {
    if constexpr (WIDE)
      ma::softmax_av_wide<HD>(key, v_all, HD, nrows, row0, N, scal[1], scal[2],
                              [&](int row, int col, int8_t c0, int8_t c1) {
                                char2 v;
                                v.x = c0;
                                v.y = c1;
                                *reinterpret_cast<char2*>(out_row(row) + col) = v;
                              });
    else
      ma::softmax_av_rows<JT>(load, v_all, HD, nrows, row0, N, scal[1], scal[2], out_row);
    if (stamps != nullptr) __syncthreads();
    stamp(4);
  }
  if (stamps != nullptr) __syncthreads();
  stamp(5);
}

// One item per CTA: item blockIdx.x of `a` (attention_rows.cuh), one stage,
// gc query groups a chunk.
template <bool LIS, int HDP, bool WIDE>
__global__ void __launch_bounds__(p2v::kThreads, 3)
    attention_rows_kernel(p2v::vit_item::Items a, const float* __restrict__ scal, int gc) {
  extern __shared__ __align__(16) int8_t dsmem[];
  const p2v::vit_item::Layout L = p2v::vit_item::layout(a.N, a.hd, LIS, 1, gc);
  p2v::vit_item::stage_item<p2v::kThreads>(L, a, blockIdx.x, dsmem);
  p2v::cp_async_wait<0>();
  __syncthreads();
  p2v::vit_item::attend_item<LIS, HDP, p2v::kThreads, WIDE>(L, a, blockIdx.x, dsmem, dsmem, scal);
}

// The most one CTA may take; an SM's 228 KB, 1 KB of it reserved per CTA.
constexpr int kMaxSmem = 232448;
constexpr int kSmSmem = 233472;
constexpr int kMaxHd = 128;  // the widest head_dim the per-item body takes (padded to HDP 128)

// Query groups a chunk: the most CTAs an SM (4, 3, 2) whose shared memory
// fits one group, then the fewest chunks at that size; force > 0 as given.
int rows_gc(int N, int hd, bool lis, int force) {
  if (force > 0) return p2v::vit_item::fit_gc(N, hd, lis, 1, kMaxSmem, force);
  for (int per_sm = 4; per_sm >= 2; --per_sm) {
    const int gc = p2v::vit_item::fit_gc(N, hd, lis, 1, kSmSmem / per_sm - 1024, 0);
    if (gc > 0) return gc;
  }
  return p2v::vit_item::fit_gc(N, hd, lis, 1, kMaxSmem, 0);
}

using RowsKernel = void (*)(p2v::vit_item::Items, const float*, int);

template <bool LIS>
RowsKernel rows_kernel_of(int n, int hdp) {
  if (p2v::vit_item::wide(n, hdp)) {
    if (hdp == 32) return attention_rows_kernel<LIS, 32, true>;
    if (hdp == 64) return attention_rows_kernel<LIS, 64, true>;
    return attention_rows_kernel<LIS, 128, true>;
  }
  return hdp == 32 ? attention_rows_kernel<LIS, 32, false> : attention_rows_kernel<LIS, 64, false>;
}

RowsKernel rows_kernel(bool lis, int n, int hdp) { return lis ? rows_kernel_of<true>(n, hdp) : rows_kernel_of<false>(n, hdp); }

int launch_rows(const p2v::vit_item::Items& a, const void* scal, int items, int lis, int force_gc,
                cudaStream_t stream) {
  if (a.N < 1 || a.hd < 1 || a.hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return 0;
  const int gc = rows_gc(a.N, a.hd, lis != 0, force_gc);
  const p2v::vit_item::Layout L = p2v::vit_item::layout(a.N, a.hd, lis != 0, 1, gc);
  if (gc == 0 || L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const RowsKernel kern = rows_kernel(lis != 0, a.N, L.hdp);
  cudaError_t err = p2v::set_smem(kern, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<items, p2v::kThreads, L.total, stream>>>(a, static_cast<const float*>(scal), gc);
  return static_cast<int>(cudaGetLastError());
}

p2v::vit_item::Items fused_items(const void* qkv, void* out, int N, int C, int H) {
  auto q = static_cast<const int8_t*>(qkv);
  const int hd = C / H;
  return p2v::vit_item::Items{q, q + C, q + 2 * C, static_cast<int8_t*>(out), 3 * C, C, (size_t)N * 3 * C,
                              (size_t)N * C, N, H, hd, hd % 16 == 0 && (3 * C) % 16 == 0};
}

p2v::vit_item::Items split_items(const void* q, const void* k, const void* v, void* out, int N, int d) {
  return p2v::vit_item::Items{static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
                              static_cast<const int8_t*>(v), static_cast<int8_t*>(out), d, d, (size_t)N * d,
                              (size_t)N * d, N, 1, d, d % 16 == 0};
}

// A launch of `clusters` clusters of P.cs CTAs.
cudaLaunchConfig_t qkv_config(const QkvPlan& P, int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = P.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * P.cs);
  cfg.blockDim = dim3(p2v::kThreads);
  cfg.dynamicSmemBytes = P.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using QkvKernel = void (*)(const int8_t*, const int8_t*, const float*, const float*, const float*, int8_t*, int, int,
                           int, int, unsigned long long*);

// The instance at N tokens and head_dim HD (64 or 128), its shared memory
// and cluster size set: past 8 CTAs a cluster needs the non-portable size.
template <bool LIS>
cudaError_t qkv_kernel(int N, int hd, QkvPlan* P, QkvKernel* kern) {
  if (N < 1 || N > MAX_CLUSTER * ROWS_PER_CTA || (hd != 64 && hd != 128)) return cudaErrorInvalidValue;
  if (hd == 64) {
    *P = plan_of<64>(N);
    *kern = N > NMAX ? lis_attention_qkv_kernel<LIS, 64, true> : lis_attention_qkv_kernel<LIS, 64, false>;
  } else {
    *P = plan_of<128>(N);
    *kern = lis_attention_qkv_kernel<LIS, 128, true>;
  }
  if (P->smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = p2v::set_smem(*kern, P->smem);
  if (err == cudaSuccess && P->cs > 8)
    err = cudaFuncSetAttribute(*kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

int launch_qkv(const void* h, const void* w, const void* r, const void* b, const void* scal, void* out, int B, int N,
               int Cin, int C, int H, int lis, void* stamps, cudaStream_t stream) {
  if (H < 1 || C % H) return static_cast<int>(cudaErrorInvalidValue);
  QkvPlan P;
  QkvKernel kern;
  cudaError_t err = lis ? qkv_kernel<true>(N, C / H, &P, &kern) : qkv_kernel<false>(N, C / H, &P, &kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qkv_config(P, B * H, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const int8_t*>(h), static_cast<const int8_t*>(w),
                           static_cast<const float*>(r), static_cast<const float*>(b), static_cast<const float*>(scal),
                           static_cast<int8_t*>(out), N, Cin, C, H, static_cast<unsigned long long*>(stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's launch facts at N tokens and head_dim hd: info = {CTAs per
// cluster, dynamic shared memory per CTA, registers per thread, local
// (spill) bytes per thread, clusters the card can hold at once, CTAs per SM}.
template <bool LIS>
int qkv_info(int N, int hd, int* info) {
  QkvPlan P;
  QkvKernel kern;
  cudaError_t err = qkv_kernel<LIS>(N, hd, &P, &kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qkv_config(P, 1, nullptr, &attr);
  int clusters = 0, per_sm = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, p2v::kThreads, P.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = P.cs;
  info[1] = P.smem;
  info[2] = fa.numRegs;
  info[3] = static_cast<int>(fa.localSizeBytes);
  info[4] = clusters;
  info[5] = per_sm;
  return 0;
}

}  // namespace

extern "C" int p2v_lis_attention_qkv_fused(const void* h, const void* w, const void* r,
                                           const void* b, const void* scal, void* out, int B,
                                           int N, int Cin, int C, int H, int lis, void* stream) {
  if (B == 0) return 0;
  return launch_qkv(h, w, r, b, scal, out, B, N, Cin, C, H, lis, nullptr, static_cast<cudaStream_t>(stream));
}

// The same launch with a measurement hook: stamps (6 × uint64) receives the
// %globaltimer (ns) of one CTA (rank 0 of the middle cluster) at its start
// and after the qkv GEMM (with the
// first cluster barrier), the K/V/q copy (with the second), the scores, the
// LIS weights (LIS off: the softmax and attn@v rows) and attn@v.
extern "C" int p2v_lis_attention_qkv_fused_timed(const void* h, const void* w, const void* r,
                                                 const void* b, const void* scal, void* out, int B,
                                                 int N, int Cin, int C, int H, int lis, void* stamps,
                                                 void* stream) {
  if (B == 0) return 0;
  return launch_qkv(h, w, r, b, scal, out, B, N, Cin, C, H, lis, stamps, static_cast<cudaStream_t>(stream));
}

extern "C" int p2v_lis_attention_qkv_info(int N, int hd, int lis, void* info) {
  auto p = static_cast<int*>(info);
  return lis ? qkv_info<true>(N, hd, p) : qkv_info<false>(N, hd, p);
}

// (B, N, 3C) qkv codes -> (B, N, C), head_dim C/H ≤ 128; force_gc > 0: that
// many query groups a chunk (a measurement hook)
extern "C" int p2v_lis_attention_fused_forced(const void* qkv, const void* scal, void* out, int B, int N, int C,
                                              int H, int lis, int force_gc, void* stream) {
  if (H < 1 || C % H) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows(fused_items(qkv, out, N, C, H), scal, B * H, lis, force_gc, static_cast<cudaStream_t>(stream));
}

extern "C" int p2v_lis_attention_fused(const void* qkv, const void* scal, void* out, int B, int N, int C, int H,
                                       int lis, void* stream) {
  return p2v_lis_attention_fused_forced(qkv, scal, out, B, N, C, H, lis, 0, stream);
}

// (BH, N, d) q, k, v codes -> (BH, N, d), d ≤ 128; force_gc as above
extern "C" int p2v_lis_attention_forced(const void* q, const void* k, const void* v, const void* scal, void* out,
                                        int BH, int N, int d, int lis, int force_gc, void* stream) {
  return launch_rows(split_items(q, k, v, out, N, d), scal, BH, lis, force_gc, static_cast<cudaStream_t>(stream));
}

extern "C" int p2v_lis_attention(const void* q, const void* k, const void* v, const void* scal, void* out, int BH,
                                 int N, int d, int lis, void* stream) {
  return p2v_lis_attention_forced(q, k, v, scal, out, BH, N, d, lis, 0, stream);
}

// The rows kernel's launch facts at N tokens and head_dim hd (force_gc as
// above): out = {padded head_dim, query groups a chunk, dynamic shared
// memory, registers per thread, spill bytes per thread, CTAs per SM}.
extern "C" int p2v_vit_attention_info(int N, int hd, int lis, int force_gc, void* out) {
  if (N < 1 || hd < 1 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  const int gc = rows_gc(N, hd, lis != 0, force_gc);
  const p2v::vit_item::Layout L = p2v::vit_item::layout(N, hd, lis != 0, 1, gc);
  if (gc == 0 || L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const RowsKernel kern = rows_kernel(lis != 0, N, L.hdp);
  cudaError_t err = p2v::set_smem(kern, L.total);
  cudaFuncAttributes fa{};
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, p2v::kThreads, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[6] = {L.hdp, gc, L.total, fa.numRegs, static_cast<int>(fa.localSizeBytes), per_sm};
  for (int i = 0; i < 6; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}
