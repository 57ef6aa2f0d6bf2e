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
// plain version's loop, so the two agree bit for bit on any input; no tensor
// core and no reassociation.
//
// Bound on the H100: the float32 products, 2·M·C·K operations (1.85 GFLOP
// at Swin-T batch 64, M = 200,704, K = 48, C = 96): 0.0276 ms at the
// 67 TFLOP/s FMA peak, 0.0552 ms with a separate multiply and add, which
// the fixed order needs. The design feeds the FP32 pipe, not the
// shared-memory pipe:
// * register blocking: a CTA takes 64 patch rows at a time; thread
//   (row group rg, channel group cg) of its 16 × 16 holds 4 rows × CC
//   channels of h in registers (CC = C_pad/16: 6 at C = 96); per 4 k it
//   reads the 4 rows' x as float4s and, per k, its CC weights as float2s or
//   float4s, then issues 4·CC multiply-add pairs: (4 + 4·CC/G)/(16·CC)
//   shared loads a product (G the weight load's width; 0.17 at C = 96);
//   a thread's channels are G-wide groups 16·G apart, so the weight loads
//   of a half-warp hit distinct banks;
// * the weight, transposed to (K, C), and the five vectors live in shared
//   memory, staged once per CTA; the grid is persistent and each block's
//   64 contiguous patch rows arrive by cp.async into one of two buffers
//   while the block before is computed;
// * the epilogue in registers: + bias, · inv_sbn, the biased rounding
//   (matmul_tiles.cuh), · mask; the row sums over the 16 lanes of a row
//   group by shuffles, exact: float lane sums where every mask is an
//   integer of magnitude ≤ 8 (|x| ≤ 1024, checked per CTA), else int64 of
//   the truncated x (row_sums); the LN chain ln_code_fast (ln_chain.cuh),
//   round, clip and byte in one saturating conversion, and a row with
//   non-finite constants (0/0) ln_code_exact; the codes go through a
//   shared-memory tile out as 16-byte stores.
// Past C = 256 a cluster of CS = ⌈C/256⌉ CTAs (at most 16, the H100's
// largest cluster, past 8 with the non-portable size: C ≤ 4096) splits
// the channels: CTA r of a cluster holds columns [r·CP, (r + 1)·CP) of the
// weight and the vectors (CP = C_pad/CS = 16·CC, CC 12 or 16), every CTA of
// the cluster takes the same 64 patch rows, and after its shuffles each row
// group's lane 0 leaves the row's exact partial sums (int64) in shared
// memory; a cluster barrier, then every thread adds the CS partials of its
// rows from the peers' shared memory (ld.shared::cluster) in rank order, so
// each CTA's LN pass sees the whole row's Σx and Σx². The partials are
// double-buffered by the block's parity, so one cluster barrier a block
// suffices, and a last barrier keeps every CTA's shared memory alive until
// its peers have read it. The k order of each product is unchanged.
// The wrapper zero-pads K to 4 and C to CS·16·CC (zero products added at the
// end of the sum change no bit; zero vectors keep the padded channels out
// of the row sums); the LN counts the true C.
#include "ln_chain.cuh"

namespace {

constexpr int kThreads = p2v::kThreads;  // 256: 16 row groups × 16 channel groups
constexpr int kRows = 4;                 // rows a thread holds
constexpr int kBlock = 16 * kRows;       // patch rows a CTA block

constexpr int kMaxCluster = 16;         // CTAs a cluster splitting C: C ≤ 16·256

struct StemPlan {
  int cc, c_pad, blocks, grid, smem, cs, clusters;  // grid in CTAs: clusters taken × cs
};

// Channels a thread holds at a CTA's padded width: CC of {2, 4, 6, 8, 12, 16}.
__host__ __device__ constexpr int cc_of(int c) {
  return c <= 32 ? 2 : c <= 64 ? 4 : c <= 96 ? 6 : c <= 128 ? 8 : c <= 192 ? 12 : c <= 256 ? 16 : 0;
}

// The CTA's transposed weight (K, CP), the five vectors, two buffers of 64
// patch rows, the 64 × CP code tile and, in a cluster, two buffers of the
// 64 rows' partial sums.
inline int stem_smem(int kp, int cp, int cs) {
  return 4 * (kp * cp + 5 * cp + 2 * kBlock * kp) + kBlock * cp + (cs > 1 ? 2 * kBlock * 16 : 0);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the 16 bytes at `p` (this CTA's shared memory) in cluster CTA `rank`
__device__ __forceinline__ void ld_peer(const long long* p, uint32_t rank, long long& a, long long& b) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  asm volatile("ld.shared::cluster.v2.u64 {%0, %1}, [%2];\n" : "=l"(a), "=l"(b) : "r"(addr) : "memory");
}

// The weight load's width (floats) at CC channels a thread.
template <int CC>
constexpr int kG = CC % 4 == 0 ? 4 : 2;

// The column of channel j (0..CC-1) of channel group cg: G-wide groups
// 16·G apart.
template <int CC>
__device__ __forceinline__ int col_of(int cg, int j) {
  constexpr int G = kG<CC>;
  return G * cg + 16 * G * (j / G) + j % G;
}

// vecs rows: bias, inv_sbn, mask, w_os, b_os (each cs·CP); px (M, kp), w (cs·CP, kp);
// cs: the cluster's CTAs (1: no cluster), CTA r holding columns [r·CP, (r + 1)·CP)
template <int CC>
__global__ void __launch_bounds__(kThreads, CC <= 8 ? 3 : 2)
    swin_stem_kernel(const float* __restrict__ px, const float* __restrict__ w, const float* __restrict__ vecs,
                     const float* __restrict__ s1p, int8_t* __restrict__ out, int M, int kp, int c_true,
                     int blocks, int cs) {
  constexpr int CP = 16 * CC, G = kG<CC>;
  extern __shared__ __align__(16) float sm[];
  float* wt = sm;                          // (kp, CP)
  float* vs = wt + kp * CP;                // (5, CP)
  float* xs = vs + 5 * CP;                 // 2 × (64, kp)
  int8_t* ot = reinterpret_cast<int8_t*>(xs + 2 * kBlock * kp);  // (64, CP)
  long long* part = reinterpret_cast<long long*>(ot + kBlock * CP);  // cluster: 2 × (64, {Σx, Σx²})
  const int tid = threadIdx.x, cg = tid & 15, rg = tid >> 4;
  const int rank = cs > 1 ? static_cast<int>(cluster_rank()) : 0, ct = cs * CP, col0 = rank * CP;
  const int cluster = blockIdx.x / cs, clusters = gridDim.x / cs;

  // the block's 64 contiguous patch rows into buffer `buf` (rows past M not copied)
  auto fetch = [&](int blk, int buf) {
    const int m0 = blk * kBlock, n4 = min(kBlock, M - m0) * kp / 4;
    const float* src = px + (size_t)m0 * kp;
    float* dst = xs + buf * kBlock * kp;
    for (int i = tid; i < n4; i += kThreads)
      p2v::cp_async16(reinterpret_cast<int8_t*>(dst + 4 * i), reinterpret_cast<const int8_t*>(src + 4 * i));
    p2v::cp_async_commit();
  };
  if (cluster < blocks) fetch(cluster, 0);  // in flight while the weight is staged
  const float* wc = w + (size_t)col0 * kp;
  for (int idx = tid; idx < CP * kp; idx += kThreads) wt[(idx % kp) * CP + idx / kp] = wc[idx];
  // every mask an integer of magnitude ≤ 8; every LN vector finite, and m·x too
  int small = 1, finite = 1;
  for (int c = tid; c < CP; c += kThreads) {
    float v5[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) vs[v * CP + c] = v5[v] = vecs[v * ct + col0 + c];
    small &= (v5[2] == rintf(v5[2]) && fabsf(v5[2]) <= 8.f) ? 1 : 0;
    finite &= (isfinite(__fmul_rn(v5[2], 32640.f)) && isfinite(v5[3]) && isfinite(v5[4])) ? 1 : 0;
  }
  const bool fast = __syncthreads_and(small) != 0;
  const bool finite_cols = __syncthreads_and(finite) != 0;
  const float s1 = s1p[0], cf = static_cast<float>(c_true);

  int it = 0;
  for (int blk = cluster; blk < blocks; blk += clusters, ++it) {
    if (blk + clusters < blocks)
      fetch(blk + clusters, (it + 1) & 1);
    else
      p2v::cp_async_commit();  // an empty group keeps the count of the wait below
    p2v::cp_async_wait<1>();
    __syncthreads();  // this block's rows have landed; the last block's codes are stored
    const float* xb = xs + (it & 1) * kBlock * kp + kRows * rg * kp;

    float acc[kRows][CC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < CC; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int k = 0; k < kp; k += 4) {
      float4 xv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) xv[i] = *reinterpret_cast<const float4*>(xb + i * kp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = wt + (k + kk) * CP + G * cg;
        float wv[CC];
#pragma unroll
        for (int v = 0; v < CC / G; ++v) {
          if constexpr (G == 4) {
            const float4 t = *reinterpret_cast<const float4*>(wr + 16 * G * v);
            wv[4 * v] = t.x, wv[4 * v + 1] = t.y, wv[4 * v + 2] = t.z, wv[4 * v + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(wr + 16 * G * v);
            wv[2 * v] = t.x, wv[2 * v + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int j = 0; j < CC; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xk, wv[j]));
        }
      }
    }

    // the epilogue: codes, x = code·mask, the row sums over the row group's 16 lanes
    long long sx[kRows], sxx[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      p2v::FastSums fs;
      sx[i] = sxx[i] = 0;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = col_of<CC>(cg, j);
        const float code = p2v::rint_clipf(__fmul_rn(__fadd_rn(acc[i][j], vs[c]), vs[CP + c]), -128.f, 127.f);
        acc[i][j] = __fmul_rn(code, vs[2 * CP + c]);  // x
        if (fast) {
          fs.add(acc[i][j]);
        } else {
          const long long xi = static_cast<long long>(acc[i][j]);
          sx[i] += xi;
          sxx[i] += xi * xi;
        }
      }
      if (fast) {  // |Σx| ≤ 16·1024, Σx² ≤ 16·2^20: exact floats
        fs.end_chunk();
        sx[i] = __float2int_rn(fs.sx);
        sxx[i] = fs.sxx;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        sx[i] += __shfl_xor_sync(0xffffffffu, sx[i], o);
        sxx[i] += __shfl_xor_sync(0xffffffffu, sxx[i], o);
      }
    if (cs > 1) {  // the whole row's sums: the cluster's partials, in rank order
      long long* pb = part + (it & 1) * 2 * kBlock;
      if (cg == 0)
#pragma unroll
        for (int i = 0; i < kRows; ++i) pb[2 * (kRows * rg + i)] = sx[i], pb[2 * (kRows * rg + i) + 1] = sxx[i];
      cluster_sync();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        sx[i] = sxx[i] = 0;
        for (int r = 0; r < cs; ++r) {
          long long a, b;
          ld_peer(pb + 2 * (kRows * rg + i), r, a, b);
          sx[i] += a;
          sxx[i] += b;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const p2v::LnRow lr = p2v::ln_row(__ll2float_rn(sx[i]), __ll2float_rn(sxx[i]), s1, cf);
      const bool ok = finite_cols && isfinite(lr.s1_over_std) && isfinite(lr.mean_over_std);
      int8_t* orow = ot + (kRows * rg + i) * CP;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = col_of<CC>(cg, j);
        const float w_os = vs[3 * CP + c], b_os = vs[4 * CP + c];
        orow[c] = static_cast<int8_t>(ok ? p2v::ln_code_fast<true>(lr, acc[i][j], w_os, b_os, 1.f)
                                         : p2v::ln_code_exact(lr, acc[i][j], w_os, b_os));
      }
    }
    __syncthreads();  // the block's codes are in the tile; its rows are read
    const int m0 = blk * kBlock, nrows = min(kBlock, M - m0);
    for (int i = tid; i < nrows * (CP / 16); i += kThreads) {
      const int r = i / (CP / 16), c16 = i - r * (CP / 16);
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * ct + col0 + 16 * c16) =
          *reinterpret_cast<const uint4*>(ot + r * CP + 16 * c16);
    }
  }
  p2v::cp_async_wait<0>();
  if (cs > 1) cluster_sync();  // the peers have read this CTA's partial sums
}

using StemKernel = void (*)(const float*, const float*, const float*, const float*, int8_t*, int, int, int, int,
                            int);

StemKernel kernel_of(int cc) {
  switch (cc) {
    case 2: return swin_stem_kernel<2>;
    case 4: return swin_stem_kernel<4>;
    case 6: return swin_stem_kernel<6>;
    case 8: return swin_stem_kernel<8>;
    case 12: return swin_stem_kernel<12>;
    case 16: return swin_stem_kernel<16>;
    default: return nullptr;
  }
}

cudaLaunchConfig_t launch_config(int grid, int cs, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan at (M, kp, cp) and its kernel: CS = ⌈cp/256⌉ CTAs a cluster of
// CP = cp/CS columns each, the card's SMs, the kernel's resident CTAs at its
// shared memory and, in clusters, the resident clusters (cached per kernel,
// device, size and CS).
cudaError_t plan_of(int M, int kp, int cp, StemPlan* plan, StemKernel* kern, int* per_sm_out, int* sms_out) {
  const int cs = (cp + 255) / 256;
  if (cp < 16 || cs > kMaxCluster || cp % cs) return cudaErrorInvalidValue;
  const int cpc = cp / cs, cc = cc_of(cpc);
  if (cc == 0 || cpc != 16 * cc || kp < 4 || kp % 4) return cudaErrorInvalidValue;
  *kern = kernel_of(cc);
  const int smem = stem_smem(kp, cpc, cs);
  if (smem > 232448) return cudaErrorInvalidValue;
  struct Entry {
    StemKernel kern;
    int dev, smem, cs, sms, per_sm, clusters;
  };
  static Entry cache[32];
  static int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Entry* hit = nullptr;
  for (const Entry& e : cache)
    if (e.kern == *kern && e.dev == dev && e.smem == smem && e.cs == cs) hit = &e;
  Entry e{*kern, dev, smem, cs, 0, 0, 0};
  if (hit != nullptr) {
    e = *hit;
  } else {
    err = p2v::set_smem(*kern, smem);
    if (err == cudaSuccess && cs > 8) err = cudaFuncSetAttribute(*kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&e.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&e.per_sm, *kern, kThreads, smem);
    e.clusters = e.sms * e.per_sm;
    if (err == cudaSuccess && cs > 1) {
      cudaLaunchAttribute attr{};
      const cudaLaunchConfig_t cfg = launch_config(cs, cs, smem, nullptr, &attr);
      err = cudaOccupancyMaxActiveClusters(&e.clusters, *kern, &cfg);
    }
    if (err != cudaSuccess) return err;
    if (e.per_sm < 1 || e.clusters < 1) return cudaErrorInvalidConfiguration;
    cache[next++ % 32] = e;
  }
  const int blocks = (M + kBlock - 1) / kBlock;
  *plan = StemPlan{cc, cp, blocks, (blocks < e.clusters ? blocks : e.clusters) * cs, smem, cs, e.clusters};
  *per_sm_out = e.per_sm;
  *sms_out = e.sms;
  return cudaSuccess;
}

}  // namespace

// px (M, kp) float32, kp % 4 == 0; w (cp, kp) float32, cp = CS·16·cc_of(cp/CS)
// with CS = ⌈cp/256⌉ ≤ 16; vecs (5, cp); s1 (1,); out (M, cp) int8; the LN
// counts c_true channels. grid > 0: that many clusters of CS CTAs (CTAs at
// CS = 1) in place of the plan's (a measurement hook).
extern "C" int p2v_fused_swin_stem_forced(const void* px, const void* w, const void* vecs, const void* s1, void* out,
                                          int M, int kp, int cp, int c_true, int grid, void* stream) {
  if (M == 0) return 0;
  if (c_true < 1 || c_true > cp || grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  StemPlan p{};
  StemKernel kern = nullptr;
  int per_sm = 0, sms = 0;
  cudaError_t err = plan_of(M, kp, cp, &p, &kern, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr{};
  const cudaLaunchConfig_t cfg = launch_config(grid > 0 ? grid * p.cs : p.grid, p.cs, p.smem,
                                               static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(px), static_cast<const float*>(w),
                           static_cast<const float*>(vecs), static_cast<const float*>(s1), static_cast<int8_t*>(out),
                           M, kp, c_true, p.blocks, p.cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2v_fused_swin_stem(const void* px, const void* w, const void* vecs, const void* s1, void* out, int M,
                                   int kp, int cp, int c_true, void* stream) {
  return p2v_fused_swin_stem_forced(px, w, vecs, s1, out, M, kp, cp, c_true, 0, stream);
}

// The launch facts at (M, kp, cp): out = {channels a thread, cp, rows a CTA
// block, blocks, grid (CTAs), shared memory a CTA, registers, spill bytes,
// CTAs per SM, SMs, CTAs a cluster, resident clusters}.
extern "C" int p2v_fused_swin_stem_info(int M, int kp, int cp, void* out) {
  StemPlan p{};
  StemKernel kern = nullptr;
  int per_sm = 0, sms = 0;
  cudaError_t err = plan_of(M, kp, cp, &p, &kern, &per_sm, &sms);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[12] = {p.cc, p.c_pad, kBlock, p.blocks, p.grid, p.smem, fa.numRegs,
                        static_cast<int>(fa.localSizeBytes), per_sm, sms, p.cs, p.clusters};
  for (int i = 0; i < 12; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}
