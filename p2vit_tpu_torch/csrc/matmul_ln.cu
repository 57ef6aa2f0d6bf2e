// int8 matmul + residual junction + the following integer LN (ops/matmul_ln.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/matmul_ln.py:int8_matmul_res_ln.
// Per row m:  mid = clip(round(acc·r + b)); res = clip(round((mid·s_mid +
// res_in·s_res)·inv_s_out)); ln = clip(round(LN(res·mask)·ratio)); two int8
// outputs, res and ln. The LN counts the row's true width n_true; the
// wrapper zero-pads N to a multiple of 16 and K to a multiple of 32, and
// zero vectors past n_true make those columns add nothing to the row sums.
//
// Bound on the H100: the bytes (x, the residual codes and the two outputs;
// 0.19 ms per DeiT-S forward at batch 64); the kernel itself is bound by
// its per-element epilogue (~55 instructions an element: the junction
// chain, then the LN chain), which the SMs must issue. The design, on
// gemm_wgmma.cuh's parts:
// * whole rows per cluster: a cluster of CS CTAs owns 64·NC rows (NC
//   consumer warpgroups, 64 rows each, per CTA), CTA r taking cpc chunks of
//   BN columns from column r·cpc·BN; the grid is persistent, the clusters
//   taking row blocks in turn. CS spreads a row block's columns, and so its
//   epilogue, over more SMs where the row blocks are too few to fill the
//   card (Swin-T stage 3: 25 blocks of 128 rows; batches 1 and 8), and
//   splits the weight panel each CTA streams from L2;
// * a producer thread TMA-loads, per ring stage, the 64·NC x rows and BN w
//   rows of 128 K bytes (128-byte swizzle, zeros past M, N and K); the
//   consumers run wgmma.m64nBNk32 on the same stage, so the weight panel is
//   read once per 64·NC rows;
// * each warp owns 16 rows of its consumer's tile (thread (w, l) holds rows
//   16w + l/4 + 8h), so a CTA's row sum is a quad shuffle: no exchange
//   across warps; with CS > 1, the lanes holding a row's sums publish them in
//   shared memory and arrive on each peer's mbarrier (release), and read the
//   peers' sums of the same rows through distributed shared memory after
//   their own barrier completes (acquire): integer sums, exact in any order;
// * the warp copies its 16 residual rows (cp.async, 16 bytes a lane) into
//   its rows of a 64 × (cpc·BN) code tile in shared memory while its
//   products run; after each chunk, the junction chain runs on the
//   accumulator registers, reads the residual code from the tile, writes
//   the new code in its place and adds x = code·mask into Σx (int32) and
//   Σx² (int64, exact for any PTF mask) in registers;
// * after the last chunk, the row constants once per row, then the LN pass
//   over the warp's rows in the tile: a lane owns four columns (their
//   vectors read once) and walks the rows; both outputs are stored as
//   coalesced 4-byte words;
// * the nine per-column vectors are staged in shared memory once per CTA;
// * codes held biased (clip + 1.5·2^23: the int8 byte is the low byte of
//   the float's bits), so rounding and conversion take adds, not the
//   conversion pipe; proven equal to rintf-then-clip over all 2^32 floats.
// res_ln_plan picks CS, BN, cpc and NC (ops/matmul_ln.res_ln_plan mirrors it).
#include "gemm_wgmma.cuh"

namespace p2v {
namespace wg {

constexpr int kLnMaxConsumers = kRowMaxConsumers;
constexpr int kLnMaxCluster = kRowMaxCluster;
constexpr int kLnWidths[] = {256, 192, 144, 128, 96};  // kWidths' tile widths

// Shared memory: 1024 B of alignment slack, the ring ((64·NC + BN)·128 B a
// stage), NC code tiles of 64 rows over the CTA's cpc chunks, the nine
// vectors over them, the row constants (8 B a row), a full and an empty
// barrier per stage and, in clusters, two row-sum barriers and two buffers
// of the rows' partial sums (16 B a row).
inline int res_ln_smem(int bn, int cpc, int nc, int stages, int cs) {
  const int nw = bn * cpc;
  return 1024 + stages * (kBM * nc + bn) * kBK + nc * kBM * code_ld(nw) + 9 * nw * 4 + nc * kBM * 8 +
         16 * stages + (cs > 1 ? 16 + 2 * nc * kBM * 16 : 0);
}

// The launch plan at (M, N): whole_row_plan (gemm_wgmma.cuh) over
// res_ln_smem and every width of kWidths.
inline RowPlan res_ln_plan(int M, int N, const int* resident, int force_cs = 0, int force_nc = 0) {
  return whole_row_plan(M, N, kLnWidths, 5, res_ln_smem, resident, force_cs, force_nc);
}

// vecs rows: r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio (each N).
// Launched in clusters of cs CTAs (cs = 1: one CTA a cluster).
template <int BN>
__global__ void __launch_bounds__(threads_of(kLnMaxConsumers), 1)
    res_ln_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                  const int8_t* __restrict__ res, const float* __restrict__ vecs, const float* __restrict__ s1p,
                  int8_t* __restrict__ res_out, int8_t* __restrict__ ln_out, int M, int N, int n_true, int K, int cpc,
                  int cs, int nc, int stages, float lo, float hi) {
  const int nw = cpc * BN, ldc = code_ld(nw);
  const int rows = kBM * nc, stage_bytes = (rows + BN) * kBK;
  const uint32_t rank = cs > 1 ? cluster_rank() : 0;
  const int n0 = static_cast<int>(rank) * nw;              // the CTA's first column
  const int ncols = max(0, min(nw, N - n0));               // its columns inside N
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* codes = reinterpret_cast<int8_t*>(smem + stages * stage_bytes);  // [64·nc][ldc]
  float* vs = reinterpret_cast<float*>(codes + rows * ldc);                // [9][nw]
  float2* lnrows = reinterpret_cast<float2*>(vs + 9 * nw);                 // [64·nc] row constants
  uint64_t* full = reinterpret_cast<uint64_t*>(lnrows + rows);
  uint64_t* empty = full + stages;
  uint64_t* sums = empty + stages;                         // cs > 1, [2]: the peers' sums of a block landed
  RowSums* part = reinterpret_cast<RowSums*>(sums + 2);    // cs > 1, [2][64·nc] partial row sums

  const int nk = (K + kBK - 1) / kBK;
  for (int i = threadIdx.x; i < 9 * nw; i += blockDim.x) {
    const int v = i / nw, col = i - v * nw;
    vs[i] = col < ncols ? vecs[(size_t)v * N + n0 + col] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, nc);
    }
    if (cs > 1) {  // every peer's consumer lanes that hold row sums arrive
      mbar_init(sums, (cs - 1) * 4 * nc * 8);
      mbar_init(sums + 1, (cs - 1) * 4 * nc * 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (cs > 1)
    cluster_sync();  // the peers' barriers are initialized before any arrive
  else
    __syncthreads();
  const int cl = blockIdx.x / cs, ncl = gridDim.x / cs;  // this cluster, the clusters

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs<kLnMaxConsumers>::kProducer));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmw)) : "memory");
      int st = 0, ph = 0;  // ring stage and the parity of its current use
      for (unsigned m0 = cl * rows; m0 < static_cast<unsigned>(M); m0 += ncl * rows)
        for (int ch = 0; ch < cpc; ++ch)
          for (int s = 0; s < nk; ++s) {
            mbar_wait(empty + st, ph ^ 1);
            mbar_expect_tx(full + st, stage_bytes);
            tma_load_2d(smem + st * stage_bytes, &tmx, s * kBK, static_cast<int>(m0), full + st);
            tma_load_2d(smem + st * stage_bytes + rows * kBK, &tmw, s * kBK, n0 + ch * BN, full + st);
            if (++st == stages) st = 0, ph ^= 1;
          }
    }
  } else {
    // ---- consumers: each owns 64 rows of the cluster's block ---------------
    // Every consumer reads every stage (its own x rows, the shared w rows)
    // and releases it; the producer refills a stage once all have, so a
    // full barrier is never more than one phase ahead of the parity tested.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs<kLnMaxConsumers>::kConsumer));
    const int c = (threadIdx.x >> 7) - 1, t128 = threadIdx.x & 127, w = t128 >> 5, lane = t128 & 31;
    const int g = lane >> 2, q = lane & 3;
    int8_t* ct = codes + (c * kBM + 16 * w) * ldc;  // the warp's 16 rows
    float2* lr = lnrows + c * kBM + 16 * w;
    const float s1 = s1p[0], cf = static_cast<float>(n_true);
    const float *mask = vs + 5 * nw, *w_os = vs + 6 * nw, *b_os = vs + 7 * nw, *ratio = vs + 8 * nw;
    const int n16 = ncols / 16, n4 = ncols / 4;
    int st = 0, ph = 0, prev = 0;  // ring stage, its parity, the stage before it
    int it = 0;                    // the CTA's row blocks so far
    for (unsigned m0 = cl * rows; m0 < static_cast<unsigned>(M); m0 += ncl * rows, ++it) {
      const int r0 = static_cast<int>(m0) + c * kBM + 16 * w;  // the warp's first row
      for (int i = lane; i < 16 * n16; i += 32) {
        const int rr = i / n16, cc = (i - rr * n16) * 16;
        if (r0 + rr < M) cp_async16(ct + rr * ldc + cc, res + (size_t)(r0 + rr) * N + n0 + cc);
      }
      cp_async_commit();
      int sx[2] = {0, 0};
      long long sxx[2] = {0, 0};
      for (int ch = 0; ch < cpc; ++ch) {
        // the chunk's accumulators, live only until its junction (the
        // first wgmma overwrites them)
        int acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        // main loop: one ring stage per 128 bytes of K, one slice's wgmmas in flight
        for (int s = 0; s < nk; ++s) {
          mbar_wait(full + st, ph);
          const uint32_t a = smem_u32(smem + st * stage_bytes);
          const uint64_t da = sw128_desc(a + c * kBM * kBK), db = sw128_desc(a + rows * kBK);
          const int ksteps = (min(kBK, K - s * kBK) + 31) / 32;
          wgmma_fence();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk)
            if (kk < ksteps) wgmma_s8(acc, da + 2 * kk, db + 2 * kk, s + kk);
          wgmma_commit();
          fence_regs(acc);
          if (s > 0) {
            wgmma_wait<1>();
            if (t128 == 0) mbar_arrive(empty + prev);
          }
          prev = st;
          if (++st == stages) st = 0, ph ^= 1;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (t128 == 0) mbar_arrive(empty + prev);
        if (ch == 0) {
          cp_async_wait<0>();
          __syncwarp();  // the warp's residual rows have landed
        }
        junction_chunk<BN>(acc, ct, ldc, ch * BN, vs, nw, g, q, lo, hi, sx, sxx);
      }
      // the row sums over the quad that holds each row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 1);
        sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 2);
        sxx[h] += __shfl_xor_sync(0xffffffffu, sxx[h], 1);
        sxx[h] += __shfl_xor_sync(0xffffffffu, sxx[h], 2);
      }
      if (cs > 1) {
        // add the peers' partial sums of the same rows (their columns): the
        // lanes that hold a row's sums publish them and arrive, releasing
        // them, on every peer's barrier of this block's buffer, then wait
        // for the peers' lanes and read theirs. Two buffers and two
        // barriers: a peer writes a buffer again only after every CTA of the
        // cluster has arrived for the block between.
        RowSums* mine = part + (it & 1) * rows + c * kBM + 16 * w;
        if (q == 0) {
          mine[g] = RowSums{sxx[0], sx[0], 0};
          mine[g + 8] = RowSums{sxx[1], sx[1], 0};
          for (int p = 0; p < cs; ++p)
            if (p != static_cast<int>(rank)) mbar_arrive_peer(sums + (it & 1), p);
        }
        mbar_wait_cluster(sums + (it & 1), (it >> 1) & 1);
        if (q == 0)
          for (int p = 0; p < cs; ++p)
            if (p != static_cast<int>(rank)) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const RowSums v = ld_peer(mine + g + 8 * h, p);
                sx[h] += v.sx;
                sxx[h] += v.sxx;
              }
            }
      }
      if (q == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const LnRow row = ln_row_exact(sx[h], sxx[h], s1, cf);
          lr[g + 8 * h] = make_float2(row.s1_over_std, row.mean_over_std);
        }
      __syncwarp();  // codes and row constants visible to the warp
      // the LN pass: a lane owns four columns at a time and walks the warp's
      // rows, so the column vectors are read once per block
      const int nrows = min(16, M - r0);
      for (int c4 = lane; c4 < n4; c4 += 32) {
        const int col = 4 * c4;
        const float4 mk = *reinterpret_cast<const float4*>(mask + col);
        const float4 wo = *reinterpret_cast<const float4*>(w_os + col);
        const float4 bo = *reinterpret_cast<const float4*>(b_os + col);
        const float4 ra = *reinterpret_cast<const float4*>(ratio + col);
        const float m4[4] = {mk.x, mk.y, mk.z, mk.w}, w4[4] = {wo.x, wo.y, wo.z, wo.w},
                    b4[4] = {bo.x, bo.y, bo.z, bo.w}, r4[4] = {ra.x, ra.y, ra.z, ra.w};
#pragma unroll 2
        for (int rr = 0; rr < nrows; ++rr) {
          const uint32_t res4 = *reinterpret_cast<const uint32_t*>(ct + rr * ldc + col);
          const float2 lv = lr[rr];
          const LnRow row{lv.x, lv.y};
          uint32_t ln4 = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = __fmul_rn(__int2float_rn(static_cast<int8_t>(res4 >> (8 * e))), m4[e]);
            ln4 |= code_byte(ln_code(row, x, w4[e], b4[e], r4[e], lo, hi)) << (8 * e);
          }
          const size_t o = (size_t)(r0 + rr) * N + n0 + col;
          *reinterpret_cast<uint32_t*>(res_out + o) = res4;
          *reinterpret_cast<uint32_t*>(ln_out + o) = ln4;
        }
      }
      __syncwarp();  // the tile rows are read before the next block's copies
    }
  }
  if (cs > 1) cluster_sync();  // no CTA leaves while a peer may read its row sums
}

}  // namespace wg
}  // namespace p2v

namespace {

using ResLnKernel = void (*)(CUtensorMap, CUtensorMap, const int8_t*, const float*, const float*, int8_t*, int8_t*,
                             int, int, int, int, int, int, int, int, float, float);

// The built instances: every width of p2v::wg::kWidths.
struct Instance {
  int bn;
  ResLnKernel kern;
  bool ready;
};

Instance g_instances[] = {{256, p2v::wg::res_ln_kernel<256>, false}, {192, p2v::wg::res_ln_kernel<192>, false},
                          {144, p2v::wg::res_ln_kernel<144>, false}, {128, p2v::wg::res_ln_kernel<128>, false},
                          {96, p2v::wg::res_ln_kernel<96>, false}};

Instance* find_instance(int bn) {
  for (Instance& in : g_instances)
    if (in.bn == bn) return &in;
  return nullptr;
}

// The instance of the plan's width, its shared-memory limit raised and its
// register count checked on first use (the setmaxnreg hand-over assumes the
// launch's registers, as the requant kernel's).
cudaError_t ready(Instance* in) {
  if (in == nullptr) return cudaErrorInvalidValue;
  if (in->ready) return cudaSuccess;
  cudaFuncAttributes attr{};
  cudaError_t err = p2v::set_smem(in->kern, p2v::wg::kMaxSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, in->kern);
  if (err == cudaSuccess && attr.numRegs != p2v::wg::Regs<p2v::wg::kLnMaxConsumers>::kLaunch)
    err = cudaErrorInvalidConfiguration;
  in->ready = err == cudaSuccess;
  return err;
}

// A launch of `grid` CTAs of nc consumers in clusters of cs.
cudaLaunchConfig_t launch_config(int grid, int cs, int nc, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(p2v::wg::threads_of(nc));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of 1 to 4 CTAs the card holds at once, for a CTA of the
// kernel's size that fills shared memory (cached per device).
cudaError_t resident_clusters(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int cache[64][p2v::wg::kLnMaxCluster] = {};
  if (dev < 64 && cache[dev][0]) {
    for (int i = 0; i < p2v::wg::kLnMaxCluster; ++i) out[i] = cache[dev][i];
    return cudaSuccess;
  }
  Instance* in = find_instance(96);
  err = ready(in);
  for (int cs = 1; cs <= p2v::wg::kLnMaxCluster && err == cudaSuccess; ++cs) {
    cudaLaunchAttribute attr{};
    const cudaLaunchConfig_t cfg =
        launch_config(cs, cs, p2v::wg::kLnMaxConsumers, p2v::wg::kMaxSmem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&out[cs - 1], in->kern, &cfg);
  }
  if (err == cudaSuccess && dev < 64)
    for (int i = 0; i < p2v::wg::kLnMaxCluster; ++i) cache[dev][i] = out[i];
  return err;
}

}  // namespace

// x (M, K) int8, w (N, K) int8, res (M, N) int8, K % 16 == 0, N % 16 == 0,
// all 16-byte aligned (the wrapper pads and checks); vecs (9, N) float32,
// zero past n_true; res_out, ln_out (M, N) int8. The LN counts n_true.
// force_cs, force_nc: 0, or the plan's cluster size and consumers (a
// measurement hook; cudaErrorInvalidConfiguration where that does not fit).
extern "C" int p2v_int8_matmul_res_ln_forced(const void* x, const void* w, const void* res, const void* vecs,
                                             const void* s1, void* res_out, void* ln_out, int M, int N, int n_true,
                                             int K, int qmin, int qmax, int force_cs, int force_nc, void* stream) {
  if (M == 0) return 0;
  if (N % 16 || K % 16 || n_true < 1 || n_true > N || abs(qmin) > p2v::wg::kMaxCode ||
      abs(qmax) > p2v::wg::kMaxCode)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident[p2v::wg::kLnMaxCluster];
  cudaError_t err = resident_clusters(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const p2v::wg::RowPlan plan = p2v::wg::res_ln_plan(M, N, resident, force_cs, force_nc);
  if (plan.nc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Instance* in = find_instance(plan.bn);
  err = ready(in);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tmx, tmw;
  if (!p2v::wg::tensor_map(&tmx, x, M, K, p2v::wg::kBM * plan.nc) || !p2v::wg::tensor_map(&tmw, w, N, K, plan.bn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr{};
  const cudaLaunchConfig_t cfg =
      launch_config(plan.grid, plan.cs, plan.nc, plan.smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, in->kern, tmx, tmw, static_cast<const int8_t*>(res), static_cast<const float*>(vecs),
                           static_cast<const float*>(s1), static_cast<int8_t*>(res_out), static_cast<int8_t*>(ln_out),
                           M, N, n_true, K, plan.cpc, plan.cs, plan.nc, plan.stages, static_cast<float>(qmin),
                           static_cast<float>(qmax));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2v_int8_matmul_res_ln(const void* x, const void* w, const void* res, const void* vecs,
                                      const void* s1, void* res_out, void* ln_out, int M, int N, int n_true, int K,
                                      int qmin, int qmax, void* stream) {
  return p2v_int8_matmul_res_ln_forced(x, w, res, vecs, s1, res_out, ln_out, M, N, n_true, K, qmin, qmax, 0, 0,
                                       stream);
}

// The launch facts at (M, N), N % 16 == 0 (force_cs, force_nc as above):
// out[0..16] = BN, chunks per CTA, CTAs per cluster, consumer warpgroups,
// stages, row blocks, grid, dynamic shared memory, registers per thread at
// launch, spill bytes per thread, a consumer's registers after setmaxnreg,
// CTAs per SM, SMs, and the clusters of 1, 2, 3 and 4 CTAs the card holds
// at once.
extern "C" int p2v_int8_matmul_res_ln_info(int M, int N, int force_cs, int force_nc, void* out) {
  int resident[p2v::wg::kLnMaxCluster];
  cudaError_t err = resident_clusters(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const p2v::wg::RowPlan plan = p2v::wg::res_ln_plan(M, N, resident, force_cs, force_nc);
  if (plan.nc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Instance* in = find_instance(plan.bn);
  err = ready(in);
  cudaFuncAttributes attr{};
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, in->kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in->kern, p2v::wg::threads_of(plan.nc), plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[17] = {plan.bn,
                        plan.cpc,
                        plan.cs,
                        plan.nc,
                        plan.stages,
                        plan.blocks,
                        plan.grid,
                        plan.smem,
                        attr.numRegs,
                        static_cast<int>(attr.localSizeBytes),
                        p2v::wg::Regs<p2v::wg::kLnMaxConsumers>::kConsumer,
                        per_sm,
                        p2v::wg::sm_count(),
                        resident[0],
                        resident[1],
                        resident[2],
                        resident[3]};
  for (int i = 0; i < 17; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}
