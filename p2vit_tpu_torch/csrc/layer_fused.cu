// One quantized ViT encoder layer in one launch (ops/layer_fused.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/layer_fused.py:fused_vit_layer
// (_kernel): qkv GEMM → requant → per-head attention (LIS, or the LIS-off
// fp32 softmax) → proj + residual + LN2 → fc1 + GELU → fc2 + residual + the
// next LN, from (B, N, C) h/xc codes to h'/xc' codes.
//
// Widths: the kernel runs at C and hid multiples of 64; the wrapper
// zero-pads a true width Ct (and hid) up to them, weights, vectors and
// codes alike (ops/layer_fused.layer_pad). Zero weight rows and vectors
// give the padded columns zero codes at every junction, which add nothing
// to Σx or Σx²; the LN chains divide by Ct (c_true), the heads are Ct/H
// wide, and the outputs are written Ct columns wide, so columns past Ct
// are written nowhere.
//
// The TPU kernel keeps the ~1.8 MB of DeiT-S weight panels resident in VMEM;
// an H100 block has 227 KB of shared memory, so this kernel streams the
// weights from L2 and runs the layer as three phases of one cooperative
// launch: a persistent grid of one 384-thread CTA per SM, its three
// warpgroups alike, grid.sync() between phases.
//
//   A. the qkv GEMM, M × 3C codes into a workspace: 64 × 64 tiles, each
//      warpgroup taking its own grid-stride share, on int8 wgmma; the requant
//      epilogue on the accumulators (requant_epilogue_tile, the requant
//      kernel's), 16-byte stores from a shared-memory tile;
//   B. attention, (image, head) items walked grid-stride by all 12 warps on
//      the per-item body of csrc/attention_lis.cu (attention_rows.cuh:
//      int8 mma.sync scores, p2v::lis_row, u8·s8 mma.sync attn@v over the
//      hi/lo weight planes; LIS off the float64 sum in key order), the next
//      item's q/k/v rows prefetched by cp.async into the second stage buffer;
//      its codes into a second workspace;
//   C. blocks of whole rows walked grid-stride, rounds of 64-row blocks then
//      32-row blocks over the rest (block_split: the mix whose rounds end
//      soonest): the block's attention
//      rows by TMA into a resident swizzled tile; proj → the junction against
//      xc on the accumulators (junction_chunk, the junction kernel's) into a
//      res1 code tile, the row sums of the three warpgroups' columns added →
//      LN2 from the tile (ln_code) into the MLP-input tile in the 128-byte
//      swizzle the wgmma A descriptor reads → fc1 over the resident MLP
//      input, each chunk's int32 accumulators through a staging tile into the
//      GELU epilogue (requant_code, rolled) and the GELU tile, swizzled → fc2
//      over the resident GELU tile → the junction against res1 (in the tile)
//      and the next LN into xo / ho with 4-byte stores.
//
// Every product is a chunk of 64 output columns (wgmma.m64n64k32 s8·s8);
// warpgroup w takes chunks w, w + 3, … of each block's sequence (proj, fc1,
// fc2), or its share of phase A's tiles. Each warpgroup owns a two-stage
// TMA ring: its first thread loads, per 128 bytes of K, the chunk's 64
// weight rows (in phase A also 64 h rows) and, once the stage's products
// are done, the position two ahead in its own sequence (across chunks and
// blocks: weights only depend on the sequence), so no warpgroup waits for
// another's main loop and all 12 warps run the epilogues, the GELU chain
// above all, which the SMs must issue. The workspaces are written by generic
// stores and read by TMA (the async proxy) in the next phase: every thread
// fences the proxies before grid.sync(); shared tiles written by threads
// and read by wgmma are fenced the same way before their barrier.
//
// Each epilogue calls the standalone kernels' own device functions (the
// int32 products are exact in any order, the float chains are the same
// instructions in the same order), so the layer equals the four-kernel path
// (int8_matmul_requant → lis_attention_fused → int8_matmul_res_ln →
// int8_matmul_requant(gelu) → int8_matmul_res_ln) bit for bit, on both
// softmax arms.
//
// Shared memory (layout(); ops/layer_fused.layer_plan mirrors it): the
// largest phase, at DeiT-S C: the rings (48 KB), the GELU tile (64 × hid,
// which holds the block's attention rows during proj), the MLP-input tile
// (64 × C), the res1 tile, three int32 staging tiles and the row sums;
// phase B at N = 197, head_dim 64: two stages, V transposed and two weight
// planes, 212,992 B. Bound on the card: the int8 products (~0.025 ms per
// DeiT-S batch-64 layer); the kernel is bound by the LIS row chain (B) and
// the GELU epilogue (C), which the SMs must issue.
#include <cooperative_groups.h>

#include <algorithm>

#include "attention_rows.cuh"
#include "gemm_wgmma.cuh"

namespace p2v {
namespace layer {

namespace cg = cooperative_groups;
using namespace wg;

constexpr int kNC = 3;                         // warpgroups, every one a consumer
constexpr int kThreadsL = 128 * kNC;
constexpr int kBN = 64;                        // output columns of a chunk, every product
constexpr int kRing = 2;                       // stages of a warpgroup's own ring
constexpr int kStageA = (kBM + kBN) * kBK;     // phase A: 64 h rows, 64 w rows, 128 K bytes each
constexpr int kStageC = kBN * kBK;             // phase C: 64 w rows
constexpr int kHalf = 32;                      // GELU staging: half a chunk's columns
constexpr int kGeluLd = kHalf + 4;             // ints per staging row
constexpr int kTile = kBM * kBK;               // one 64-row K-block of a swizzled tile
constexpr int kBarBytes = 8 * (2 * kNC * kRing + 1);

struct Layout {
  int hdp, gc;         // attention: padded head_dim, query groups a chunk
  int ot, end_a;       // phase A: the rings, then the warpgroups' output tiles
  int end_b;           // phase B: the attention item's stages and planes (from 0)
  int gelu, mlp, res1, gst, part, lnr, end_c;  // phase C, after the rings
  int bar, smem;       // the barriers (after every phase); dynamic bytes with alignment slack
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// force_gc > 0: that many attention query groups a chunk (a measurement
// hook); else the most that fit.
__host__ __device__ inline Layout layout(int N, int C, int hd, int hid, bool lis, int force_gc) {
  Layout l{};
  l.hdp = vit_item::pad_hd(hd);
  l.ot = kNC * kRing * kStageA;
  l.end_a = l.ot + kNC * kBM * (kBN + 16);
  l.gelu = kNC * kRing * kStageC;
  l.mlp = l.gelu + kTile * ceil_div(hid > C ? hid : C, kBK);
  l.res1 = l.mlp + kTile * ceil_div(C, kBK);
  l.gst = l.res1 + kBM * code_ld(C);
  l.part = l.gst + kNC * kBM * kGeluLd * 4;
  l.lnr = l.part + kNC * kBM * static_cast<int>(sizeof(RowSums));
  l.end_c = l.lnr + kBM * 8;
  l.gc = vit_item::fit_gc(N, hd, lis, 2, kMaxSmem - 1024 - kBarBytes, force_gc);
  l.end_b = vit_item::layout(N, hd, lis, 2, l.gc).total;
  int end = l.end_a > l.end_b ? l.end_a : l.end_b;
  end = end > l.end_c ? end : l.end_c;
  l.bar = (end + 7) / 8 * 8;
  l.smem = 1024 + l.bar + kBarBytes;
  return l;
}

// The byte of (row, col) in a 64-row tile of 128-byte K-blocks (8 KB each),
// 128-byte swizzled as TMA writes and the wgmma descriptors read.
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 7) * kTile + row * kBK + ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// A warpgroup's ring: stage p % 2 of position p, its full barrier's phase
// (p / 2) % 2. stage: the stage's bytes; b_off: the w rows' offset in it.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  int stage, b_off;
};

// Ring position p ← the B box at (k0, b_row) and, if ta, the A box at (k0,
// a_row); by the warpgroup's first thread, once position p − 2's products
// are done.
__device__ __forceinline__ void load(const Ring& R, int p, const CUtensorMap* ta, int a_row, const CUtensorMap* tb,
                                     int b_row, int k0) {
  uint8_t* dst = R.base + (p & 1) * R.stage;
  uint64_t* bar = R.full + (p & 1);
  mbar_expect_tx(bar, ta != nullptr ? kStageA : kStageC);
  if (ta != nullptr) tma_load_2d(dst, ta, k0, a_row, bar);
  tma_load_2d(dst + R.b_off, tb, k0, b_row, bar);
}

// The products of one chunk over ring positions [pos, pos + nk), K bytes; A
// from the stage or, where a_res ≠ 0, from the resident swizzled tile at
// shared address a_res. After each position's products, refill() (the
// first thread) loads the position two ahead into the spent stage.
template <class Refill>
__device__ __forceinline__ void products(const Ring& R, int (&acc)[kBN / 2], int pos, int nk, int K, uint32_t a_res,
                                         Refill&& refill, int t128) {
  for (int s = 0; s < nk; ++s) {
    const int p = pos + s;
    mbar_wait(R.full + (p & 1), (p >> 1) & 1);
    const uint32_t a = smem_u32(R.base + (p & 1) * R.stage);
    const uint64_t da = sw128_desc(a_res != 0 ? a_res + s * kTile : a), db = sw128_desc(a + R.b_off);
    const int ksteps = (min(kBK, K - s * kBK) + 31) / 32;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      if (kk < ksteps) wgmma_s8(acc, da + 2 * kk, db + 2 * kk, s + kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (t128 == 0) refill();
  }
}

// The block's row sums (each warpgroup's over its columns, added through
// `part`) → the LN row constants in lnr; ends synced.
__device__ __forceinline__ void row_consts(int (&sx)[2], long long (&sxx)[2], RowSums* part, float2* lnr, int c, int w,
                                           int g, int q, float s1, float cf) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 1);
    sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 2);
    sxx[h] += __shfl_xor_sync(0xffffffffu, sxx[h], 1);
    sxx[h] += __shfl_xor_sync(0xffffffffu, sxx[h], 2);
  }
  if (q == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) part[c * kBM + 16 * w + g + 8 * h] = RowSums{sxx[h], sx[h], 0};
  __syncthreads();
  if (c == 0 && q == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h;
      int tx = 0;
      long long txx = 0;
#pragma unroll
      for (int u = 0; u < kNC; ++u) tx += part[u * kBM + row].sx, txx += part[u * kBM + row].sxx;
      const LnRow lr = ln_row_exact(tx, txx, s1, cf);
      lnr[row] = make_float2(lr.s1_over_std, lr.mean_over_std);
    }
  __syncthreads();
}

// The LN pass over the block's first `rows` rows of the code tile (the
// junction kernel's): warp wv (0..11) takes rows wv, wv + 12, …; a lane
// takes 4 columns at a time; out(row, col, 4 codes, 4 LN codes).
template <class Out>
__device__ __forceinline__ void ln_pass(const int8_t* ct, int ldc, const float2* lnr, const float* __restrict__ vecs,
                                        int C, int rows, int wv, int lane, Out&& out) {
  const float *mask = vecs + 5 * C, *w_os = vecs + 6 * C, *b_os = vecs + 7 * C, *ratio = vecs + 8 * C;
  for (int c4 = lane; c4 < C / 4; c4 += 32) {
    const int col = 4 * c4;
    const float4 mk = __ldg(reinterpret_cast<const float4*>(mask + col));
    const float4 wo = __ldg(reinterpret_cast<const float4*>(w_os + col));
    const float4 bo = __ldg(reinterpret_cast<const float4*>(b_os + col));
    const float4 ra = __ldg(reinterpret_cast<const float4*>(ratio + col));
    const float m4[4] = {mk.x, mk.y, mk.z, mk.w}, w4[4] = {wo.x, wo.y, wo.z, wo.w}, b4[4] = {bo.x, bo.y, bo.z, bo.w},
                r4[4] = {ra.x, ra.y, ra.z, ra.w};
    for (int rr = wv; rr < rows; rr += 4 * kNC) {
      const uint32_t res4 = *reinterpret_cast<const uint32_t*>(ct + rr * ldc + col);
      const float2 lv = lnr[rr];
      const LnRow row{lv.x, lv.y};
      uint32_t ln4 = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fmul_rn(__int2float_rn(static_cast<int8_t>(res4 >> (8 * e))), m4[e]);
        ln4 |= code_byte(ln_code(row, x, w4[e], b4[e], r4[e], -128.f, 127.f)) << (8 * e);
      }
      out(rr, col, res4, ln4);
    }
  }
}

// fc1's GELU epilogue of one chunk (columns n0 … n0 + 63) of the block's
// first `rows` rows: half a chunk's int32 accumulators at a time through
// this warpgroup's staging tile, then a rolled loop (one column a thread: r
// and b in registers) of requant_code's GELU chain into the swizzled GELU
// tile.
__device__ __forceinline__ void gelu_chunk(const int (&acc)[kBN / 2], int* gs, uint8_t* gelu, int n0,
                                           const float* __restrict__ f1v, int hid, float inv, int rows, int c, int w,
                                           int g, int q, int t128) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    named_sync(1 + c, 128);  // the staging tile's last readers are done
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * half + j4;
        *reinterpret_cast<int2*>(gs + (16 * w + g + 8 * h) * kGeluLd + 8 * j4 + 2 * q) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    named_sync(1 + c, 128);
    const int col = t128 & 31, n = n0 + kHalf * half + col;
    const float r = __ldg(f1v + n), b = __ldg(f1v + hid + n);
#pragma unroll 2
    for (int row = t128 >> 5; row < rows; row += 4)
      gelu[swz(row, n)] = static_cast<uint8_t>(requant_code(gs[row * kGeluLd + col], r, b, inv, true, -128.f, 127.f));
  }
}

// scal: rq, s_attn, ro, x0_int, b_int, c_int (the attention's), fc1_out_inv,
// s1_ln2, s1_lnn. qv (2, 3C), f1v (2, hid): requant and bias; pv, f2v (9, C):
// the junction vectors. n64: phase C's blocks of 64 rows; 32-row blocks
// take the rest (their products run on 64 rows, their epilogues on 32). ws: (M, 3C) qkv codes then (M, C) attention codes,
// written and read inside the launch (tm_attn maps the second). stamps, if
// not null: block 0's %globaltimer (ns) at the start and after each phase.
// C, hid: the padded widths (multiples of 64); Ct: the true width, H heads
// of Ct/H; ho and xo are (M, Ct). WIDE = vit_item::wide(N, HDP).
template <bool LIS, int HDP, bool WIDE>
__global__ void __launch_bounds__(kThreadsL, 1)
    fused_vit_layer_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_attn, const __grid_constant__ CUtensorMap tm_proj,
                           const __grid_constant__ CUtensorMap tm_fc1, const __grid_constant__ CUtensorMap tm_fc2,
                           const int8_t* __restrict__ xc, const float* __restrict__ qv, const float* __restrict__ pv,
                           const float* __restrict__ f1v, const float* __restrict__ f2v,
                           const float* __restrict__ scal, int8_t* ws, int8_t* __restrict__ ho,
                           int8_t* __restrict__ xo, unsigned long long* stamps, int B, int N, int C, int Ct, int H,
                           int hid, int force_gc, int n64) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::grid_group grid = cg::this_grid();
  auto stamp = [&](int i) {
    if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(stamps[i])::"memory");
  };
  stamp(0);
  const Layout L = layout(N, C, Ct / H, hid, LIS, force_gc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bar);  // [2][kNC][kRing] ring barriers, then the A tile's
  uint64_t* a_full = bars + 2 * kNC * kRing;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kNC * kRing + 1; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int M = B * N, C3 = 3 * C, hd = Ct / H;
  const int nkc = ceil_div(C, kBK), nkh = ceil_div(hid, kBK);
  // phase C's blocks: n64 of 64 rows, then 32-row blocks over the rest
  const int ncc = C / kBN, nch = hid / kBN, nb = n64 + ceil_div(max(0, M - 64 * n64), 32);
  const int tn = C3 / kBN, tiles = ceil_div(M, kBM) * tn;
  int8_t* qkv = ws;
  int8_t* attn = ws + (size_t)M * C3;
  const int c = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  const int w = t128 >> 5, lane = t128 & 31, g = lane >> 2, q = lane & 3;
  if (threadIdx.x == 0) {
    const CUtensorMap* maps[6] = {&tm_h, &tm_qkv, &tm_attn, &tm_proj, &tm_fc1, &tm_fc2};
    for (int i = 0; i < 6; ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i])) : "memory");
  }

  // ---- A: qkv GEMM → qact1 codes; warpgroup c's tiles c + 3·blockIdx.x + 3·grid·j
  {
    const Ring R{sm + c * kRing * kStageA, bars + c * kRing, kStageA, kBM * kBK};
    const int first = kNC * blockIdx.x + c, step = kNC * gridDim.x;
    int lt = first, ls = 0, lp = 0;  // the next position to load: tile, K step, ring position
    auto refill = [&]() {
      if (lt >= tiles) return;
      load(R, lp++, &tm_h, (lt / tn) * kBM, &tm_qkv, (lt % tn) * kBN, ls * kBK);
      if (++ls == nkc) ls = 0, lt += step;
    };
    if (t128 == 0)
      for (int i = 0; i < kRing; ++i) refill();
    int8_t* ot = reinterpret_cast<int8_t*>(sm + L.ot) + c * kBM * (kBN + 16);
    int pos = 0;
    for (int t = first; t < tiles; t += step, pos += nkc) {
      const int m0 = (t / tn) * kBM, n0 = (t % tn) * kBN;
      int acc[kBN / 2];
      products(R, acc, pos, nkc, C, 0, refill, t128);
      named_sync(1 + c, 128);  // the last tile's stores have read ot
      requant_epilogue_tile<kBN>(acc, qv + n0, qv + C3 + n0, ot, 1.f, -128.f, 127.f);
      named_sync(1 + c, 128);  // ot written
      store_tile<kBN, 16>(ot, qkv, M, C3, m0, n0);
    }
  }
  fence_proxy_async();
  grid.sync();
  stamp(1);

  // ---- B: attention per (image, head) → qact2 codes
  {
    const vit_item::Layout AL = vit_item::layout(N, hd, LIS, 2, L.gc);
    // 16-byte copies where head_dim is a multiple of 16 (C % 64 == 0 makes
    // the rows so); byte loads below, which a 16-byte copy would read into
    // the next head's codes. q, k and v of the heads lie in the first Ct
    // columns of their C-wide parts.
    const vit_item::Items it{qkv, qkv + C, qkv + 2 * C, attn, C3, C, (size_t)N * C3, (size_t)N * C, N, H, hd,
                             hd % 16 == 0};
    int8_t* base = reinterpret_cast<int8_t*>(sm);
    const int items = B * H;
    if (blockIdx.x < items) vit_item::stage_item<kThreadsL>(AL, it, blockIdx.x, base);
    int k = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
      cp_async_wait<0>();
      __syncthreads();  // this item's rows landed; the last item is done with every buffer
      if (item + gridDim.x < items)
        vit_item::stage_item<kThreadsL>(AL, it, item + gridDim.x, base + ((k + 1) & 1) * AL.stage);
      vit_item::attend_item<LIS, HDP, kThreadsL, WIDE>(AL, it, item, base + (k & 1) * AL.stage, base, scal);
    }
  }
  fence_proxy_async();  // the codes and this CTA's shared memory, before TMA reads or writes them
  grid.sync();
  stamp(2);

  // ---- C: per 64-row block, proj + LN2, fc1 + GELU, fc2 + next LN. A
  // block's chunk sequence: proj 0 … ncc − 1, fc1, fc2; warpgroup c takes
  // its entries c, c + 3, …
  {
    const int nseq = 2 * ncc + nch;
    const Ring R{sm + c * kRing * kStageC, bars + kNC * kRing + c * kRing, kStageC, 0};
    int lb = blockIdx.x, lq = c, ls = 0, lp = 0;  // the next position to load: block, sequence entry, K step
    auto refill = [&]() {
      if (lb >= nb) return;
      const bool fc2 = lq >= ncc + nch;
      const CUtensorMap* tb = lq < ncc ? &tm_proj : fc2 ? &tm_fc2 : &tm_fc1;
      const int row = (lq < ncc ? lq : fc2 ? lq - ncc - nch : lq - ncc) * kBN;
      load(R, lp++, nullptr, 0, tb, row, ls * kBK);
      if (++ls == (fc2 ? nkh : nkc)) {
        ls = 0;
        lq += kNC;
        if (lq >= nseq) lq = c, lb += gridDim.x;
      }
    };
    if (t128 == 0)
      for (int i = 0; i < kRing; ++i) refill();
    const int ldc = code_ld(C);
    int8_t* res1 = reinterpret_cast<int8_t*>(sm + L.res1);
    int8_t* ctw = res1 + 16 * w * ldc;  // the warp's 16 rows of the tile
    uint8_t* gelu = sm + L.gelu;
    uint8_t* mlp = sm + L.mlp;
    int* gs = reinterpret_cast<int*>(sm + L.gst) + c * kBM * kGeluLd;
    RowSums* part = reinterpret_cast<RowSums*>(sm + L.part);
    float2* lnr = reinterpret_cast<float2*>(sm + L.lnr);
    const uint32_t mlp_a = smem_u32(mlp), gelu_a = smem_u32(gelu);
    const float fc1_inv = scal[6], s1_ln2 = scal[7], s1_lnn = scal[8], cf = static_cast<float>(Ct);
    const bool vec4 = Ct % 4 == 0;  // 4-byte output stores
    const int wv = 4 * c + w;
    // the block's attention rows into the GELU tile's place (proj's A operand)
    auto load_a = [&](int blk) {
      mbar_expect_tx(a_full, nkc * kTile);
      const int m0 = blk < n64 ? 64 * blk : 64 * n64 + 32 * (blk - n64);
      for (int s = 0; s < nkc; ++s) tma_load_2d(gelu + s * kTile, &tm_attn, s * kBK, m0, a_full);
    };
    if (threadIdx.x == 0 && blockIdx.x < nb) load_a(blockIdx.x);
    int pos = 0, j = 0;
    for (int blk = blockIdx.x; blk < nb; blk += gridDim.x, ++j) {
      const int m0 = blk < n64 ? 64 * blk : 64 * n64 + 32 * (blk - n64);
      const int rows = min(blk < n64 ? 64 : 32, M - m0);
      // xc's codes at this warpgroup's proj columns → the res1 tile
      for (int ch = c; ch < ncc; ch += kNC)
        for (int i = t128; i < kBM * (kBN / 16); i += 128) {
          const int rr = i / (kBN / 16), cc = ch * kBN + 16 * (i % (kBN / 16));
          if (rr < rows) cp_async16(res1 + rr * ldc + cc, xc + (size_t)(m0 + rr) * C + cc);
        }
      cp_async_commit();
      mbar_wait(a_full, j & 1);
      int sx[2] = {0, 0};
      long long sxx[2] = {0, 0};
      // proj → the junction with xc → res1 codes in the tile
      for (int ch = c; ch < ncc; ch += kNC, pos += nkc) {
        int acc[kBN / 2];
        products(R, acc, pos, nkc, C, gelu_a, refill, t128);
        if (ch == c) {
          cp_async_wait<0>();
          named_sync(1 + c, 128);  // this warpgroup's residual columns landed
        }
        if (16 * w < rows) junction_chunk<kBN>(acc, ctw, ldc, ch * kBN, pv, C, g, q, -128.f, 127.f, sx, sxx);
      }
      // LN2 → the MLP input, swizzled
      row_consts(sx, sxx, part, lnr, c, w, g, q, s1_ln2, cf);
      ln_pass(res1, ldc, lnr, pv, C, rows, wv, lane, [&](int rr, int col, uint32_t, uint32_t ln4) {
        *reinterpret_cast<uint32_t*>(mlp + swz(rr, col)) = ln4;
      });
      fence_proxy_async();
      __syncthreads();  // the MLP input is whole and visible to wgmma; proj is done with the GELU tile's place
      // fc1 + GELU → the GELU tile, swizzled
      for (int e = c; e < nseq; e += kNC) {
        if (e < ncc || e >= ncc + nch) continue;
        int acc[kBN / 2];
        products(R, acc, pos, nkc, C, mlp_a, refill, t128);
        pos += nkc;
        gelu_chunk(acc, gs, gelu, (e - ncc) * kBN, f1v, hid, fc1_inv, rows, c, w, g, q, t128);
      }
      fence_proxy_async();
      __syncthreads();  // the GELU tile is whole and visible to wgmma
      // fc2 → the junction with res1 → xo codes in the tile; the next LN → ho
      sx[0] = sx[1] = 0;
      sxx[0] = sxx[1] = 0;
      for (int e = c; e < nseq; e += kNC) {
        if (e < ncc + nch) continue;
        int acc[kBN / 2];
        products(R, acc, pos, nkh, hid, gelu_a, refill, t128);
        pos += nkh;
        if (16 * w < rows)
          junction_chunk<kBN>(acc, ctw, ldc, (e - ncc - nch) * kBN, f2v, C, g, q, -128.f, 127.f, sx, sxx);
      }
      row_consts(sx, sxx, part, lnr, c, w, g, q, s1_lnn, cf);
      // fc2's products are done: the next block's attention rows may take the GELU tile's place
      if (threadIdx.x == 0 && blk + gridDim.x < nb) load_a(blk + gridDim.x);
      ln_pass(res1, ldc, lnr, f2v, C, rows, wv, lane, [&](int rr, int col, uint32_t res4, uint32_t ln4) {
        if (col >= Ct) return;
        const size_t o = (size_t)(m0 + rr) * Ct + col;
        if (vec4) {
          *reinterpret_cast<uint32_t*>(xo + o) = res4;
          *reinterpret_cast<uint32_t*>(ho + o) = ln4;
        } else {
          for (int e = 0; e < 4 && col + e < Ct; ++e) {
            xo[o + e] = static_cast<int8_t>(res4 >> (8 * e));
            ho[o + e] = static_cast<int8_t>(ln4 >> (8 * e));
          }
        }
      });
      __syncthreads();  // the tiles are read before the next block writes them
    }
  }
  if (stamps != nullptr) {
    grid.sync();
    stamp(3);
  }
}

}  // namespace layer
}  // namespace p2v

namespace {

using namespace p2v::layer;

using LayerKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                             const int8_t*, const float*, const float*, const float*, const float*, const float*,
                             int8_t*, int8_t*, int8_t*, unsigned long long*, int, int, int, int, int, int, int, int);

template <bool LIS>
LayerKernel kernel_lis(int n, int hdp) {
  if (p2v::vit_item::wide(n, hdp)) {
    if (hdp == 32) return fused_vit_layer_kernel<LIS, 32, true>;
    if (hdp == 64) return fused_vit_layer_kernel<LIS, 64, true>;
    return fused_vit_layer_kernel<LIS, 128, true>;
  }
  return hdp == 32 ? fused_vit_layer_kernel<LIS, 32, false> : fused_vit_layer_kernel<LIS, 64, false>;
}

LayerKernel kernel_of(bool lis, int n, int hdp) { return lis ? kernel_lis<true>(n, hdp) : kernel_lis<false>(n, hdp); }

// The shapes the kernel takes (the wrapper's check_fits mirrors them): C and
// hid multiples of 64 holding Ct = H·hd, hd a divisor of 128 (or 128), as
// JAX's assert admits; shared memory bounds N and the widths (plan).
bool takes(int B, int N, int C, int Ct, int H, int hid) {
  if (B < 1 || N < 1 || H < 1 || Ct < 1 || Ct > C || Ct % H || C % kBN || hid < 1 || hid % kBN) return false;
  const int hd = Ct / H;
  return hd <= 128 && 128 % hd == 0;
}

struct Launch {
  Layout L;
  LayerKernel kern;
  int grid, per_sm, sms, n64, nb;
  cudaFuncAttributes fa;
};

// Phase C's blocks of 64 rows: rounds of 64-row blocks over the grid, then
// 32-row blocks over the rest, each at about 3/4 of a 64-row block's time
// (measured: the epilogues skip the empty half, the products and the
// weight stream do not); the number of 64-row rounds whose blocks end
// soonest, the fewest 64-row blocks on a tie. force_br: 64 (all) or 32
// (none).
int block_split(int M, int grid, int force_br) {
  const int nb64 = (M + 63) / 64;
  if (force_br == 64) return nb64;
  if (force_br == 32) return 0;
  int best = 0, best_t = -1;
  for (int f = 0; f <= (nb64 + grid - 1) / grid; ++f) {
    const int n64 = std::min(nb64, f * grid), n32 = (std::max(0, M - 64 * n64) + 31) / 32;
    const int t = 4 * ((n64 + grid - 1) / grid) + 3 * ((n32 + grid - 1) / grid);
    if (best_t < 0 || t < best_t) best_t = t, best = n64;
  }
  return best;
}

// The plan at these shapes: one CTA an SM, grid = min(SMs, the largest
// phase's work items: at least the qkv tiles, never fewer than phase C's
// blocks), phase C's block_split; force_grid (≤ the CTAs the card holds at
// once), force_gc, force_br > 0 take their place.
cudaError_t plan(int B, int N, int C, int Ct, int H, int hid, int lis, int force_grid, int force_gc, int force_br,
                 Launch* out) {
  if (!takes(B, N, C, Ct, H, hid) || (force_br != 0 && force_br != 32 && force_br != 64))
    return cudaErrorInvalidValue;
  Launch l{};
  l.L = layout(N, C, Ct / H, hid, lis != 0, force_gc);
  if (l.L.gc < 1 || l.L.smem > p2v::wg::kMaxSmem) return cudaErrorInvalidValue;
  l.kern = kernel_of(lis != 0, N, l.L.hdp);
  cudaError_t err = p2v::set_smem(l.kern, l.L.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&l.fa, l.kern);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.per_sm, l.kern, kThreadsL, l.L.smem);
  if (err != cudaSuccess) return err;
  l.sms = p2v::wg::sm_count();
  if (l.per_sm < 1 || l.sms < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int M = B * N;
  const int tiles = (M + kBM - 1) / kBM * (3 * C / kBN);
  l.grid = force_grid > 0 ? force_grid : std::min(l.sms, std::max(tiles, B * H));
  if (l.grid > l.sms * l.per_sm) return cudaErrorCooperativeLaunchTooLarge;
  l.n64 = block_split(M, l.grid, force_br);
  l.nb = l.n64 + (std::max(0, M - 64 * l.n64) + 31) / 32;
  *out = l;
  return cudaSuccess;
}

}  // namespace

// (B, N, C) h / xc codes -> (B, N, Ct) ho / xo codes (C, hid padded to
// multiples of 64 around the true width Ct, as the wrapper pads them); ws
// holds B·N·4C bytes;
// stamps: null, or 4 uint64 for the phase timestamps. force_grid,
// force_gc, force_br > 0: the grid, the attention's query groups a chunk and
// phase C's rows a block, 32 or 64 for every block (a measurement hook).
extern "C" int p2v_fused_vit_layer_forced(const void* h, const void* xc, const void* wqkv, const void* qv,
                                          const void* wproj, const void* pv, const void* wfc1, const void* f1v,
                                          const void* wfc2, const void* f2v, const void* scal, void* ws, void* ho,
                                          void* xo, void* stamps, int B, int N, int C, int Ct, int H, int hid,
                                          int lis, int force_grid, int force_gc, int force_br, void* stream) {
  if (B == 0) return 0;
  Launch l;
  cudaError_t err = plan(B, N, C, Ct, H, hid, lis, force_grid, force_gc, force_br, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * N;
  auto* wsp = static_cast<int8_t*>(ws);
  CUtensorMap tm_h, tm_qkv, tm_attn, tm_proj, tm_fc1, tm_fc2;
  if (!p2v::wg::tensor_map(&tm_h, h, M, C, kBM) || !p2v::wg::tensor_map(&tm_qkv, wqkv, 3 * C, C, kBN) ||
      !p2v::wg::tensor_map(&tm_attn, wsp + (size_t)M * 3 * C, M, C, kBM) ||
      !p2v::wg::tensor_map(&tm_proj, wproj, C, C, kBN) || !p2v::wg::tensor_map(&tm_fc1, wfc1, hid, C, kBN) ||
      !p2v::wg::tensor_map(&tm_fc2, wfc2, C, hid, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(l.grid);
  cfg.blockDim = dim3(kThreadsL);
  cfg.dynamicSmemBytes = l.L.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, l.kern, tm_h, tm_qkv, tm_attn, tm_proj, tm_fc1, tm_fc2,
                           static_cast<const int8_t*>(xc), static_cast<const float*>(qv),
                           static_cast<const float*>(pv), static_cast<const float*>(f1v),
                           static_cast<const float*>(f2v), static_cast<const float*>(scal), wsp,
                           static_cast<int8_t*>(ho), static_cast<int8_t*>(xo),
                           static_cast<unsigned long long*>(stamps), B, N, C, Ct, H, hid, force_gc, l.n64);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2v_fused_vit_layer(const void* h, const void* xc, const void* wqkv, const void* qv, const void* wproj,
                                   const void* pv, const void* wfc1, const void* f1v, const void* wfc2,
                                   const void* f2v, const void* scal, void* ws, void* ho, void* xo, void* stamps,
                                   int B, int N, int C, int Ct, int H, int hid, int lis, void* stream) {
  return p2v_fused_vit_layer_forced(h, xc, wqkv, qv, wproj, pv, wfc1, f1v, wfc2, f2v, scal, ws, ho, xo, stamps, B,
                                    N, C, Ct, H, hid, lis, 0, 0, 0, stream);
}

// The launch facts at these shapes (force_grid, force_gc, force_br as
// above): out[0..15] = threads, grid, dynamic shared memory, phase A's, B's
// and C's bytes, attention query groups a chunk, padded head_dim, registers
// per thread, spill bytes per thread, CTAs per SM, SMs, stages of a
// warpgroup's ring, chunk width, phase C's 64-row blocks and all its blocks.
extern "C" int p2v_fused_vit_layer_info(int B, int N, int C, int Ct, int H, int hid, int lis, int force_grid,
                                        int force_gc, int force_br, void* out) {
  Launch l;
  const cudaError_t err = plan(B, N, C, Ct, H, hid, lis, force_grid, force_gc, force_br, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[16] = {kThreadsL, l.grid, l.L.smem, 1024 + l.L.end_a, 1024 + l.L.end_b, 1024 + l.L.end_c, l.L.gc,
                        l.L.hdp, l.fa.numRegs, static_cast<int>(l.fa.localSizeBytes), l.per_sm, l.sms, kRing, kBN,
                        l.n64, l.nb};
  for (int i = 0; i < 16; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}
