// int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax, over
// head_dim D = 64 (ops/attention_lis.py).
//
// * p2v_lis_attention_qkv_fused replaces the Pallas kernel
//   p2vit_tpu/ops/attention_lis.py:lis_attention_qkv_fused (_qkv_fused_kernel
//   -> heads_attention): qkv projection and attention, the qkv codes kept on
//   chip. One thread-block cluster per (image, head), ceil(N/64) ≤ 4 CTAs
//   (cudaLaunchKernelEx with a cluster dimension), the per-tile bodies in
//   attention_mma.cuh:
//   1. CTA r computes the head's q, k and v codes of token rows
//      [64r, 64r + 64) as one Gemm<64, 192> tile of the image's (N, Cin)
//      codes against the gathered weight rows {q, k, v}·C + head·D + dd,
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
//   heads_attention): one block per (image, head) copies the head's q/k/v
//   rows out of the (B, N, 3C) qkv codes.
// * p2v_lis_attention replaces lis_attention (_kernel): one block per
//   (batch·head) copies its rows out of split (BH, N, D) q, k and v.
//
// The last two share one per-row body (attend_rows, in attention_rows.cuh
// with the per-item row copy, so that the fused encoder layer runs it too)
// over q/k/v rows held in shared memory. Shared rows are 68 bytes (17
// words), so the per-lane key rows fall in distinct banks. Nothing is
// padded: rows and keys past N are never read. Per query row, a warp: 32
// lanes × 8 key slots of dp4a scores → attn codes clip(round(acc·rq)); then
// * LIS: p2v::lis_row (common.cuh, shared with csrc/swin_attention.cu), the
//   integer weights 2^(15−q), and attn@v as the paper's shift-accumulate:
//   lane l sums output dims 2l, 2l+1 over all keys in int32, weights
//   broadcast by warp shuffle. Exact while |Σ_j v_j·2^(15−q_j)| < 2^24, i.e.
//   while a row's LIS weights sum below 4 (they sum to about 1). out =
//   clip(round(av_int·2^-15·ro)).
// * LIS off: p2v::softmax_row, then Σ_j p_j·v_j in float64 (each product of
//   a float32 and an int8 is exact there), rounded once to float32, out =
//   clip(round(av·ro)).
//
// Bound of these two: the per-score softmax chain (an IEEE divide and an
// exponent extraction per score with LIS; a float64 exp per score without)
// and shared-memory reads.
#include <cooperative_groups.h>

#include "attention_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace p2v::vit_attn;
using G = p2v::Gemm<ROWS_PER_CTA, 3 * D, 2, 4>;
static_assert(G::SMEM_BYTES >= OWN_BYTES, "the own tiles overlay the GEMM's stages");

__host__ __device__ inline QkvPlan plan_of(int N) { return qkv_plan<G::SMEM_BYTES>(N); }

template <bool LIS>
__global__ void __launch_bounds__(p2v::kThreads, 2)
    lis_attention_qkv_kernel(const int8_t* __restrict__ h, const int8_t* __restrict__ w,
                             const float* __restrict__ r, const float* __restrict__ bvec,
                             const float* __restrict__ scal, int8_t* __restrict__ out, int N,
                             int Cin, int C, int H, unsigned long long* __restrict__ stamps) {
  extern __shared__ __align__(16) int8_t dsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const QkvPlan P = plan_of(N);
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
  int8_t* own_k = dsmem + ROWS_PER_CTA * D;
  int8_t* own_v = dsmem + 2 * ROWS_PER_CTA * D;

  // 1. q/k/v codes of token rows [m0, m0 + 64) into the own tiles
  {
    const int8_t* hb = h + (size_t)img * N * Cin;
    int acc[G::MT][G::NT][4];
    G::run([&](int rr) -> const int8_t* { return m0 + rr < N ? hb + (size_t)(m0 + rr) * Cin : nullptr; },
           [&](int rr) -> const int8_t* {
             return w + (size_t)((rr / D) * C + head * D + rr % D) * Cin;
           },
           Cin, dsmem, acc);
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = G::row_of(i, e), col = G::col_of(j, e);
          const int which = col / D, dd = col % D, gn = which * C + head * D + dd;
          const int8_t code =
              m0 + row < N ? p2v::to_i8(p2v::requant(
                                 __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), r[gn]), bvec[gn]),
                                 -128.f, 127.f))
                           : int8_t(0);
          if (which == 0)
            own_q[row * D + dd] = code;
          else if (which == 1)
            own_k[row * D + dd] = code;
          else
            own_v[LIS ? dd * ROWS_PER_CTA + row : row * D + dd] = code;
        }
  }
  cluster.sync();
  stamp(1);

  // 2. the head's K and V and this CTA's q rows, out of the peers' tiles
  const int g0 = P.first_group(rank), ng = P.n_groups(rank), row0 = g0 * QGROUP, nrows = ng * QGROUP;
  int8_t* k_all = dsmem + P.k_all;
  int8_t* v_all = dsmem + P.v_all;
  int8_t* q_mine = dsmem + P.q_mine;
  // n rows of 64 B from row `first` on (row j in peer j/64's tile) into dst, ld bytes apart
  auto gather_rows = [&](int8_t* own, int first, int n, int8_t* dst, int ld) {
    copy16(n * 4,
           [&](int i) {
             const int row = first + (i >> 2);
             return cluster.map_shared_rank(own, row / ROWS_PER_CTA) + (row % ROWS_PER_CTA) * D + 16 * (i & 3);
           },
           [&](int i) { return dst + (i >> 2) * ld + 16 * (i & 3); });
  };
  gather_rows(own_k, 0, P.kpad, k_all, KLD);
  if constexpr (LIS) {
    const int kq = P.kpad / 16;  // 16-key chunks of a row of V^T, 4 from each peer
    copy16(D * kq,
           [&](int i) {
             const int c = i % kq;
             return cluster.map_shared_rank(own_v, c >> 2) + (i / kq) * ROWS_PER_CTA + 16 * (c & 3);
           },
           [&](int i) { return v_all + (i / kq) * P.vld + 16 * (i % kq); });
  } else {
    gather_rows(own_v, 0, P.kpad, v_all, D);
  }
  gather_rows(own_q, row0, nrows, q_mine, KLD);
  cluster.sync();  // the last read of a peer's shared memory is done
  stamp(2);

  // 3. attention of this CTA's query groups
  namespace ma = p2v::mma_attn;
  int8_t* s = dsmem + P.w_hi;
  int8_t* o = out + (size_t)img * N * C + head * D;
  const float rq = scal[0];
  ma::scores_mma<D>(q_mine, k_all, KLD, ng, P.kpad, [&](int r, int j, int a0, int a1) {
    char2 c;
    c.x = p2v::to_i8(ma::score_code(a0, rq));
    c.y = p2v::to_i8(ma::score_code(a1, rq));
    *reinterpret_cast<char2*>(s + r * P.vld + j) = c;
  });
  __syncthreads();
  stamp(3);
  auto load = [&](int r, float(&ac)[JT]) { ma::load_scores<JT>(s + r * P.vld, N, ac); };
  auto out_row = [&](int row) { return o + (size_t)row * C; };
  if constexpr (LIS) {
    ma::lis_weight_rows<JT>(load, s, dsmem + P.w_lo, P.vld, nrows, row0, N, P.kpad, scal[3], scal[4], scal[5]);
    __syncthreads();
    stamp(4);
    ma::av_mma<D>(s, dsmem + P.w_lo, v_all, P.vld, ng, P.kpad, row0, N, scal[2], out_row);
  } else {
    ma::softmax_av_rows<JT>(load, v_all, D, nrows, row0, N, scal[1], scal[2], out_row);
    if (stamps != nullptr) __syncthreads();
    stamp(4);
  }
  if (stamps != nullptr) __syncthreads();
  stamp(5);
}

// Block b = (outer, head) = (b / H, b % H): its q/k/v row i lies at
// {q,k,v} + outer·in_outer + head·D + i·in_ld; its output row i at
// out + outer·out_outer + head·D + i·out_ld.
template <bool LIS>
__global__ void __launch_bounds__(p2v::kThreads)
    attention_rows_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                          const int8_t* __restrict__ v, int in_ld, size_t in_outer,
                          const float* __restrict__ scal, int8_t* __restrict__ out, int out_ld,
                          size_t out_outer, int N, int H) {
  extern __shared__ __align__(16) int8_t dsmem[];
  attention_item<LIS>(q, k, v, in_ld, in_outer, scal, out, out_ld, out_outer, N, H, blockIdx.x, dsmem);
}

template <bool LIS>
int launch_rows(const int8_t* q, const int8_t* k, const int8_t* v, int in_ld, size_t in_outer,
                const void* scal, void* out, int out_ld, size_t out_outer, int N, int H, int blocks,
                cudaStream_t stream) {
  const int smem = 3 * N * QROW;
  cudaError_t err = p2v::set_smem(attention_rows_kernel<LIS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_rows_kernel<LIS><<<blocks, p2v::kThreads, smem, stream>>>(
      q, k, v, in_ld, in_outer, static_cast<const float*>(scal), static_cast<int8_t*>(out), out_ld,
      out_outer, N, H);
  return static_cast<int>(cudaGetLastError());
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

template <bool LIS>
int launch_qkv(const void* h, const void* w, const void* r, const void* b, const void* scal,
               void* out, int B, int N, int Cin, int C, int H, void* stamps, cudaStream_t stream) {
  if (N < 1 || N > NMAX) return static_cast<int>(cudaErrorInvalidValue);
  const QkvPlan P = plan_of(N);
  cudaError_t err = p2v::set_smem(lis_attention_qkv_kernel<LIS>, P.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qkv_config(P, B * H, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, lis_attention_qkv_kernel<LIS>, static_cast<const int8_t*>(h),
                           static_cast<const int8_t*>(w), static_cast<const float*>(r),
                           static_cast<const float*>(b), static_cast<const float*>(scal),
                           static_cast<int8_t*>(out), N, Cin, C, H,
                           static_cast<unsigned long long*>(stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's launch facts at N tokens: info = {CTAs per cluster, dynamic
// shared memory per CTA, registers per thread, local (spill) bytes per
// thread, clusters the card can hold at once, CTAs per SM}.
template <bool LIS>
int qkv_info(int N, int* info) {
  if (N < 1 || N > NMAX) return static_cast<int>(cudaErrorInvalidValue);
  const QkvPlan P = plan_of(N);
  cudaError_t err = p2v::set_smem(lis_attention_qkv_kernel<LIS>, P.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, lis_attention_qkv_kernel<LIS>);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qkv_config(P, 1, nullptr, &attr);
  int clusters = 0, per_sm = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, lis_attention_qkv_kernel<LIS>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lis_attention_qkv_kernel<LIS>, p2v::kThreads,
                                                      P.smem);
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
  auto s = static_cast<cudaStream_t>(stream);
  return lis ? launch_qkv<true>(h, w, r, b, scal, out, B, N, Cin, C, H, nullptr, s)
             : launch_qkv<false>(h, w, r, b, scal, out, B, N, Cin, C, H, nullptr, s);
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
  auto s = static_cast<cudaStream_t>(stream);
  return lis ? launch_qkv<true>(h, w, r, b, scal, out, B, N, Cin, C, H, stamps, s)
             : launch_qkv<false>(h, w, r, b, scal, out, B, N, Cin, C, H, stamps, s);
}

extern "C" int p2v_lis_attention_qkv_info(int N, int lis, void* info) {
  auto p = static_cast<int*>(info);
  return lis ? qkv_info<true>(N, p) : qkv_info<false>(N, p);
}

// (B, N, 3C) qkv codes -> (B, N, C)
extern "C" int p2v_lis_attention_fused(const void* qkv, const void* scal, void* out, int B, int N,
                                       int C, int H, int lis, void* stream) {
  if (B == 0) return 0;
  auto q = static_cast<const int8_t*>(qkv);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t in_outer = (size_t)N * 3 * C, out_outer = (size_t)N * C;
  return lis ? launch_rows<true>(q, q + C, q + 2 * C, 3 * C, in_outer, scal, out, C, out_outer, N, H,
                                 B * H, s)
             : launch_rows<false>(q, q + C, q + 2 * C, 3 * C, in_outer, scal, out, C, out_outer, N, H,
                                  B * H, s);
}

// (BH, N, D) q, k, v codes -> (BH, N, D)
extern "C" int p2v_lis_attention(const void* q, const void* k, const void* v, const void* scal,
                                 void* out, int BH, int N, int lis, void* stream) {
  if (BH == 0) return 0;
  auto qp = static_cast<const int8_t*>(q), kp = static_cast<const int8_t*>(k),
       vp = static_cast<const int8_t*>(v);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t outer = (size_t)N * D;
  return lis ? launch_rows<true>(qp, kp, vp, D, outer, scal, out, D, outer, N, 1, BH, s)
             : launch_rows<false>(qp, kp, vp, D, outer, scal, out, D, outer, N, 1, BH, s);
}
