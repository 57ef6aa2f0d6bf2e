// Windowed int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax,
// for Swin (ops/attention_lis.py swin_lis_attention and
// swin_lis_attention_folded).
//
// Replaces the Pallas kernels p2vit_tpu/ops/attention_lis.py:swin_lis_attention
// (_swin_kernel -> _swin_head_loop) and swin_lis_attention_folded
// (_swin_folded_kernel). Head_dim HD = 32 or 64 (the wrapper zero-pads
// smaller heads to one of them), N ≤ 256 tokens per window (49 for 7×7
// windows, 144 for 12×12, 256 for 16×16; at HD = 64, N ≤ 160, where two
// stage buffers still fit shared memory). Per (window, head) item:
//   scores acc = q·kᵀ → attn1 = clip(round(acc·rq)) → qact2 codes
//   clip(round((attn1·s1 + bias[h,i,j])·inv_s2)) → + mask[w mod nW, i, j]
//   (already divided by s2, added unrounded) → LIS (p2v::lis_row: the
//   int-exp, the exact two-limb exp_sum, weights 2^(15−q)) and
//   out = clip(round(Σ_j w_j·v_j·2^-15·ro)); LIS off: p2v::softmax_row at
//   s2 and out = clip(round(Σ_j p_j·v_j·ro)) with the sum in float64.
//
// The two entries differ only in where a window's rows live (token_of):
// p2v_swin_lis_attention reads (W, N, 3C) window panels, row i of window w at
// w·N + i; p2v_swin_lis_attention_folded reads the (B, res, res, 3C) raster
// qkv grid, row i of window (b, wy, wx) at pixel (b, (wy·ws + i/ws + shift)
// mod res, (wx·ws + i%ws + shift) mod res), and writes its output at the same
// pixel of (B, res, res, C). So window_partition, window_reverse and a
// shifted block's two cyclic rolls are index arithmetic in the loads and the
// store: the folded entry equals roll(−shift) → partition → the panel entry
// → reverse → roll(+shift) bit for bit, LIS on and off, by construction.
//
// Design (Hopper; the per-tile bodies are attention_mma.cuh's):
// * Items are ordered head-major, then window: item = h·W + w for W =
//   B·nW windows. A persistent grid of min(items, SMs × CTAs per SM) CTAs
//   takes them in turn from a counter in device memory, one item ahead of
//   the one it computes, so the card is filled at every stage and batch and
//   every CTA computes until the items run out: with a static split of equal
//   runs, the CTAs that share an SM finished up to 1.4× apart (the warp
//   scheduler favours some) and the SMs idled through the tail. A CTA
//   stages bias[h] (N² float32) in shared memory when its item's head
//   changes: a few times per CTA where a head has more windows than the
//   grid has CTAs (Swin-T stages 0 and 1 at batch 64), every item else.
// * The next item's q, k and v rows (3 × N × HD bytes, through a per-row
//   token index that also addresses the output) and its mask[w mod nW]
//   (N² float32) go into the other of two stage buffers by cp.async while
//   the current item computes.
// * Instances by the window's size NM: N ≤ 64 (every zoo Swin) as above;
//   64 < N ≤ 160 (JAX's 12×12 windows, N = 144, which its wrapper
//   zero-pads to 160) and 160 < N ≤ 256 (16×16 windows) read bias[h] and
//   the mask from global memory (L2) where the score epilogue and the LIS
//   rows use them, since two staged masks and bias[h] would take
//   3·N²·4 = 249 KB at N = 144, and keep the lo plane in a region of their
//   own (the spent q/k rows are too few); at NM = 256 the LIS-off rows go
//   one a warp (kOffRows 1) to fit. Keys are zero-padded to a multiple of
//   32 in all, as JAX pads them. Each NM has an HD = 32 instance; NM 64 and
//   160 also an HD = 64 one.
// * Scores on int8 tensor cores: 16-row query groups × 8-key
//   tiles of mma.sync m16n8k32 s8·s8 (|q·k| ≤ 64·128² < 2^21: exact int32,
//   equal to the dp4a sum); the epilogue runs the attn1 and qact2 requant
//   with the staged bias on the fragment and stores int8 codes.
// * LIS: p2v::lis_row per query row (one warp a row; the mask is added as
//   the row is read), its weights as the hi/lo u8 planes (the lo plane over
//   the item's spent q/k rows), attn@v as 256·(hi·V) + lo·V on mma.sync
//   m16n8k32 u8·s8 against V transposed in shared memory: the scalar
//   shift-accumulate's integer, bit for bit.
// * LIS off: p2v::softmax_row per row, then Σ_j p_j·v_j in float64 over
//   keys j < N in order (fma of an exact product rounds as the
//   multiply-then-add); v as exact doubles converted once per item, p_j
//   read back as doubles from the warp's row buffer, kOffRows rows a warp
//   side by side (independent float64 chains). Only the scores moved to the
//   tensor cores.
//
// Bound: the bytes (q/k/v codes in, codes out: 0.11 ms per Swin-T forward
// at batch 64 on the H100); the kernel is bound by the per-row LIS chain
// (two IEEE divides and an int-exp per score, three warp reductions a row),
// which the SMs must issue: about 290 instructions a row, two thirds of a
// CTA's time (the phase clock).
#include "attention_mma.cuh"

namespace {

namespace ma = p2v::mma_attn;
using p2v::kThreads;

constexpr int NSTAGED = 64;  // windows up to this many tokens stage bias[h] and the masks in shared memory
constexpr int NMID = 160;    // 12×12 = 144 tokens, keys padded to 160
constexpr int NMAX = 256;    // the largest window: 16×16 tokens
constexpr int NMAX_HD64 = NMID;  // the largest window at head_dim 64

// The sizes of the instance for windows of up to NM tokens at head_dim HD.
template <int NM, int HD>
struct Sz {
  static constexpr int QLD = HD + 16;                  // bytes per staged q / k row (conflict-free fragments)
  static constexpr int JT = NM / 32;                   // key slots per lane
  static constexpr int STAGE = 2 * NM * QLD + NM * HD;  // q, k (QLD rows) and v (dense rows) of one item
  static constexpr int WLD = NM + 16;                  // bytes per row of V transposed and of the weight planes
  static constexpr bool STAGED = NM <= NSTAGED;        // bias[h] and the masks in shared memory
  static constexpr int OFF_ROWS = NM > NMID ? 1 : 2;   // LIS off: rows a warp sums side by side
};
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;  // launches that may be in flight at once, each with its own counters

// Per launch slot: the next item to take and the CTAs done; the last CTA of
// a launch sets both back to 0 for the slot's next launch.
__device__ unsigned int g_work[kSlots][2];

// Shared memory at N tokens (byte offsets): two rows of token indices, two
// stage buffers of q, k, v rows, two of masks, the score / hi plane and
// bias[h] (the masks and bias[h] only where STAGED; else the lo plane, but
// LIS off at NM = 256); LIS: V transposed; LIS off: v as doubles and the
// warps' p rows.
struct Layout {
  int nn, tok, stg, mask, hi, lo, bias, vt, vd, pb, total;
};
__host__ __device__ constexpr int nn_bytes(int n) { return (n * n * 4 + 15) / 16 * 16; }
template <bool LIS, int NM, int HD>
__host__ __device__ constexpr Layout layout(int n) {
  using S = Sz<NM, HD>;
  Layout l{};
  l.nn = S::STAGED ? nn_bytes(n) : 0;
  l.tok = 0;
  l.stg = 2 * NM * 4;
  l.mask = l.stg + 2 * S::STAGE;
  l.hi = l.mask + 2 * l.nn;
  // STAGED: over the item's spent q/k rows; none LIS off at NM = 256 (kept at 160, where it fits)
  l.lo = S::STAGED || (!LIS && NM > NMID) ? -1 : l.hi + NM * S::WLD;
  l.bias = l.lo < 0 ? l.hi + NM * S::WLD : l.lo + NM * S::WLD;
  const int end = l.bias + l.nn;
  l.vt = end;                                              // LIS: HD × WLD
  l.vd = end;                                              // LIS off: N × HD doubles
  l.pb = end + (n * HD * 8 + 15) / 16 * 16;                // LIS off: kWarps × OFF_ROWS × NM doubles
  l.total = LIS ? l.vt + HD * S::WLD : l.pb + kWarps * S::OFF_ROWS * NM * 8;
  return l;
}

struct Geom {
  int W;      // windows
  int nW;     // windows per image: window w takes mask[w mod nW]
  int N, C, H;
  int res, ws, shift;  // folded entry: the raster grid and the block's cyclic shift
};

// Token index of row i of window `win`: the panel row, or (FOLD) the raster
// pixel of a (B, res, res) grid of ws×ws windows in (b, wy, wx) order, moved
// by the cyclic shift.
template <bool FOLD>
__device__ __forceinline__ int token_of(int win, int i, const Geom& a) {
  if constexpr (FOLD) {
    const int g = a.res / a.ws, wpi = g * g;
    const int b = win / wpi, wy = (win % wpi) / g, wx = win % g;
    int y = wy * a.ws + i / a.ws + a.shift, x = wx * a.ws + i % a.ws + a.shift;
    if (y >= a.res) y -= a.res;
    if (x >= a.res) x -= a.res;
    return (b * a.res + y) * a.res + x;
  } else {
    return win * a.N + i;
  }
}

// 4-byte global → shared copy that bypasses registers (the mask rows are
// 4-byte aligned only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// The float32 result of a float64 attn@v sum → clip(round(av·ro)) code.
__device__ __forceinline__ int8_t av_code(double av, float ro) {
  return p2v::to_i8(p2v::requant(__fmul_rn(__double2float_rn(av), ro), -128.f, 127.f));
}

// LIS off, the rows of one item: load(r, ac) → p2v::softmax_row at s2 →
// Σ_j p_j·v_j in float64 over keys j < N in order (vd: v as doubles, row j
// at vd + j·HD; lane l owns dims l, l + 32, …) → out_row(r)[l + 32u]. p_j
// goes to double once and into the warp's row buffer pb, read back by a
// broadcast load per key.
template <int NM, int HD, class Load, class OutRow>
__device__ __forceinline__ void softmax_av_swin(Load&& load, const double* vd, double* pb, int N, float s2, float ro,
                                                OutRow&& out_row) {
  using S = Sz<NM, HD>;
  constexpr int JT = S::JT, R = S::OFF_ROWS, DL = HD / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* rows = pb + warp * R * NM;
  for (int r = warp; r < N; r += R * kWarps) {
    bool has[R];
    double a[R][DL];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      has[q] = q == 0 || r + q * kWarps < N;  // a missing row reruns row r, dropped
      float ac[JT], p[JT];
      load(has[q] ? r + q * kWarps : r, ac);
      p2v::softmax_row<JT>(ac, N, s2, p);
#pragma unroll
      for (int t = 0; t < JT; ++t) rows[q * NM + lane + 32 * t] = static_cast<double>(p[t]);
#pragma unroll
      for (int u = 0; u < DL; ++u) a[q][u] = 0.0;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int u = 0; u < DL; ++u) {
        const double v = vd[j * HD + lane + 32 * u];
#pragma unroll
        for (int q = 0; q < R; ++q) a[q][u] = __fma_rn(rows[q * NM + j], v, a[q][u]);
      }
    }
    __syncwarp();  // the row buffer is read before the next rows overwrite it
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (has[q])
#pragma unroll
        for (int u = 0; u < DL; ++u) out_row(r + q * kWarps)[lane + 32 * u] = av_code(a[q][u], ro);
  }
}

// scal: rq, s1, inv_s2, ro, x0_int, b_int, c_int, s2
template <bool LIS, bool FOLD, int NM, int HD>
__global__ void __launch_bounds__(kThreads, Sz<NM, HD>::STAGED ? (LIS ? 4 : 3) : (LIS ? 2 : 1))
    swin_attention_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, const float* __restrict__ scal,
                          int8_t* __restrict__ out, Geom a, int items, unsigned long long* __restrict__ stamps,
                          unsigned long long* __restrict__ cta_ns, int slot) {
  using S = Sz<NM, HD>;
  constexpr int JT = S::JT, STAGE = S::STAGE, WLD = S::WLD, QLD = S::QLD, CH = HD / 16;
  extern __shared__ __align__(16) int8_t sm[];
  const int N = a.N;
  const Layout L = layout<LIS, NM, HD>(N);
  int* tok = reinterpret_cast<int*>(sm + L.tok);             // [2][NM] token index of each staged row
  int8_t* stg = sm + L.stg;                                  // [2][STAGE] q, k, v rows
  float* mask_s = reinterpret_cast<float*>(sm + L.mask);     // STAGED: [2][N][N] (16-byte rounded)
  int8_t* hi = sm + L.hi;                                    // [NM][WLD] qact2 codes, then the hi plane
  float* bias_s = reinterpret_cast<float*>(sm + L.bias);     // STAGED: [N][N]

  const int kpad = (N + 31) / 32 * 32, ng = (N + ma::QGROUP - 1) / ma::QGROUP, nrows = ng * ma::QGROUP;
  const float rq = scal[0], s1 = scal[1], inv_s2 = scal[2], ro = scal[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the stamped CTA: the middle one; per phase, the sum over its items
  // (stamps, zeroed by the caller, hold the running sums)
  const bool stamper = stamps != nullptr && threadIdx.x == 0 && blockIdx.x == gridDim.x / 2;
  unsigned long long t_prev = 0;
  auto clock = []() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  };
  auto stamp = [&](int k) {
    if (stamper) {
      const unsigned long long t = clock();
      stamps[k] += t - t_prev;
      t_prev = t;
    }
  };
  if (stamper) stamps[5] = t_prev = clock();
  if (cta_ns != nullptr && threadIdx.x == 0) cta_ns[2 * blockIdx.x] = clock();

  for (int i = threadIdx.x; i < 2 * STAGE / 16; i += kThreads)
    reinterpret_cast<int4*>(stg)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();  // the zeros land before any copy into the same rows

  // q, k, v rows (a thread per row and 16-byte chunk) and the mask of
  // `item` into stage buffer `buf`
  auto issue = [&](int item, int buf) {
    const int h = item / a.W, win = item - h * a.W;
    int8_t* st = stg + buf * STAGE;
    for (int t = threadIdx.x; t < CH * N; t += kThreads) {
      const int i = t / CH, part = t % CH;
      const int tk = token_of<FOLD>(win, i, a);
      if (part == 0) tok[buf * NM + i] = tk;
      const int8_t* src = qkv + (size_t)tk * 3 * a.C + h * HD + 16 * part;
      p2v::cp_async16(st + i * QLD + 16 * part, src);
      p2v::cp_async16(st + NM * QLD + i * QLD + 16 * part, src + a.C);
      p2v::cp_async16(st + 2 * NM * QLD + i * HD + 16 * part, src + 2 * a.C);
    }
    if (S::STAGED && mask != nullptr) {
      const float* src = mask + (size_t)(win % a.nW) * N * N;
      float* dst = mask_s + buf * (L.nn / 4);
      for (int i = threadIdx.x; i < N * N; i += kThreads) cp_async4(dst + i, src + i);
    }
    p2v::cp_async_commit();
  };

  // items taken from the slot's counter: the one computed and the next
  __shared__ int taken[2];
  unsigned int* work = g_work[slot];
  if (threadIdx.x == 0) taken[0] = static_cast<int>(atomicAdd(work, 1u));
  __syncthreads();
  int it = taken[0], n_items = 0;
  if (it < items) issue(it, 0);
  if (threadIdx.x == 0 && it < items) taken[1] = static_cast<int>(atomicAdd(work, 1u));
  int cur_h = -1;
  for (int k = 0; it < items; ++k) {
    const int buf = k & 1;
    p2v::cp_async_wait<0>();
    __syncthreads();  // this item's rows landed; the previous item is done with every buffer
    const int nxt = taken[(k + 1) & 1];
    // the one after: taken now, stored at the end of this item, so that the
    // atomic's round trip overlaps the item instead of stalling warp 0
    unsigned int after = 0;
    if (nxt < items) {
      issue(nxt, buf ^ 1);
      if (threadIdx.x == 0) after = atomicAdd(work, 1u);
    }
    ++n_items;
    stamp(0);
    const int h = it / a.W, win = it - h * a.W;
    const float* bias_h = bias + (size_t)h * N * N;                                   // !STAGED: read in place
    const float* mask_w = mask == nullptr ? nullptr : mask + (size_t)(win % a.nW) * N * N;  // likewise
    if (S::STAGED && h != cur_h) {
      const float* src = bias + (size_t)h * N * N;
      for (int i = threadIdx.x; i < N * N; i += kThreads) bias_s[i] = src[i];
      cur_h = h;
      if (stamper) ++stamps[8];
    }
    int8_t* qs = stg + buf * STAGE;
    const int8_t* ks = qs + NM * QLD;
    const int8_t* vs = qs + 2 * NM * QLD;
    if constexpr (LIS) {
      // V transposed (dim d, keys contiguous): warp w moves keys 8w … 8w + 7
      // (then 8w + 64 … while keys remain) of dims `lane`, lane + 32, …;
      // rows past N are zeros
      for (int k0 = 8 * warp; k0 < NM; k0 += 8 * kWarps)
#pragma unroll
        for (int u = 0; u < HD / 32; ++u) {
          const int d = lane + 32 * u;
          uint32_t w2[2] = {0, 0};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            w2[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(vs[(k0 + e) * HD + d])) << (8 * (e & 3));
          *reinterpret_cast<uint2*>(sm + L.vt + d * WLD + k0) = make_uint2(w2[0], w2[1]);
        }
    } else {
      double* vd = reinterpret_cast<double*>(sm + L.vd);
      for (int i = threadIdx.x; i < N * HD; i += kThreads) vd[i] = static_cast<double>(vs[i]);
    }
    __syncthreads();
    stamp(1);

    // scores → qact2 codes in the score plane (0 outside the N × N window;
    // key tiles wholly past N are not computed: no row reads them)
    ma::scores_mma<HD>(qs, ks, QLD, ng, (N + 7) / 8 * 8, [&](int r, int j, int a0, int a1) {
      const int accs[2] = {a0, a1};
      int8_t c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a2 = 0.f;
        if (r < N && j + e < N) {
          const float a1c = ma::score_code(accs[e], rq);
          const float b = S::STAGED ? bias_s[r * N + j + e] : __ldg(bias_h + r * N + j + e);
          a2 = p2v::requant(__fmul_rn(__fadd_rn(__fmul_rn(a1c, s1), b), inv_s2), -128.f, 127.f);
        }
        c[e] = p2v::to_i8(a2);
      }
      char2 o;
      o.x = c[0];
      o.y = c[1];
      *reinterpret_cast<char2*>(hi + r * WLD + j) = o;
    });
    __syncthreads();
    stamp(2);

    const int* tk = tok + buf * NM;
    const float* mrow = mask_s + buf * (L.nn / 4);
    auto out_row = [&](int row) { return out + (size_t)tk[row] * a.C + h * HD; };
    // row r's scores in lis_row's lane layout: the qact2 code + the mask, unrounded
    auto load = [&](int r, float(&ac)[JT]) {
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        const int j = lane + 32 * t;
        float x = 0.f;
        if (j < N) {
          x = static_cast<float>(hi[r * WLD + j]);
          if (mask != nullptr) x = __fadd_rn(x, S::STAGED ? mrow[r * N + j] : __ldg(mask_w + r * N + j));
        }
        ac[t] = x;
      }
    };
    if constexpr (LIS) {
      int8_t* lo = S::STAGED ? qs : sm + L.lo;  // STAGED: over this item's spent q/k rows
      ma::lis_weight_rows<JT>(load, hi, lo, WLD, nrows, 0, N, kpad, scal[4], scal[5], scal[6]);
      __syncthreads();
      stamp(3);
      ma::av_mma<HD>(hi, lo, sm + L.vt, WLD, ng, kpad, 0, N, ro, out_row);
      if (stamps != nullptr) __syncthreads();
      stamp(4);
    } else {
      softmax_av_swin<NM, HD>(load, reinterpret_cast<const double*>(sm + L.vd), reinterpret_cast<double*>(sm + L.pb), N,
                          scal[7], ro, out_row);
      if (stamps != nullptr) __syncthreads();
      stamp(3);
    }
    if (threadIdx.x == 0 && nxt < items) taken[k & 1] = static_cast<int>(after);
    it = nxt;
  }
  if (cta_ns != nullptr && threadIdx.x == 0) cta_ns[2 * blockIdx.x + 1] = clock();
  if (stamper) {
    stamps[5] = clock() - stamps[5];
    stamps[6] = static_cast<unsigned long long>(n_items);
    stamps[7] = static_cast<unsigned long long>(gridDim.x);
  }
  // the last CTA done (every other CTA has taken its last item) resets the slot
  if (threadIdx.x == 0) {
    __threadfence();  // this CTA's last take lands before its count
    if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {
      work[0] = 0;
      work[1] = 0;
    }
  }
}

// The card's SMs and the kernel's resident CTAs per SM at N tokens (cached
// per instance: the occupancy call costs microseconds).
template <bool LIS, bool FOLD, int NM, int HD>
cudaError_t residency(int N, int* sms, int* per_sm) {
  static int cache_dev = -1, cache_n = -1, cache_sms = 0, cache_per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cache_dev || N != cache_n) {
    const int smem = layout<LIS, NM, HD>(N).total;
    err = p2v::set_smem(swin_attention_kernel<LIS, FOLD, NM, HD>, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cache_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache_per_sm, swin_attention_kernel<LIS, FOLD, NM, HD>,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    if (cache_per_sm < 1) return cudaErrorInvalidConfiguration;
    cache_dev = dev, cache_n = N;
  }
  *sms = cache_sms, *per_sm = cache_per_sm;
  return cudaSuccess;
}

template <bool LIS, bool FOLD, int NM, int HD>
int launch_swin(const void* qkv, const void* bias, const void* mask, const void* scal, void* out, Geom g,
                int grid, void* stamps, void* cta_ns, void* stream) {
  const int items = g.W * g.H;
  if (items == 0) return 0;
  int sms = 0, per_sm = 0;
  cudaError_t err = residency<LIS, FOLD, NM, HD>(g.N, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid <= 0) grid = sms * per_sm;
  if (grid > items) grid = items;
  static int launches = 0;  // launch slots in turn
  const int slot = launches++ % kSlots;
  swin_attention_kernel<LIS, FOLD, NM, HD>
      <<<grid, kThreads, layout<LIS, NM, HD>(g.N).total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const float*>(scal), static_cast<int8_t*>(out), g, items,
      static_cast<unsigned long long*>(stamps), static_cast<unsigned long long*>(cta_ns), slot);
  return static_cast<int>(cudaGetLastError());
}

template <int NM, int HD>
int launch_nm(const void* qkv, const void* bias, const void* mask, const void* scal, void* out, Geom g, int lis,
              int fold, int grid, void* stamps, void* cta_ns, void* stream) {
  if (fold)
    return lis ? launch_swin<true, true, NM, HD>(qkv, bias, mask, scal, out, g, grid, stamps, cta_ns, stream)
               : launch_swin<false, true, NM, HD>(qkv, bias, mask, scal, out, g, grid, stamps, cta_ns, stream);
  return lis ? launch_swin<true, false, NM, HD>(qkv, bias, mask, scal, out, g, grid, stamps, cta_ns, stream)
             : launch_swin<false, false, NM, HD>(qkv, bias, mask, scal, out, g, grid, stamps, cta_ns, stream);
}

// The head_dim each row of the (·, 3C) codes gives a head: C/H, 32 or 64
// (the wrapper pads smaller heads); 0 where no instance takes it.
int head_dim(const Geom& g) {
  if (g.H < 1 || g.C % g.H) return 0;
  const int hd = g.C / g.H;
  return hd == 32 || (hd == 64 && g.N <= NMAX_HD64) ? hd : 0;
}

int launch_any(const void* qkv, const void* bias, const void* mask, const void* scal, void* out, Geom g, int lis,
               int fold, int grid, void* stamps, void* cta_ns, void* stream) {
  const int hd = head_dim(g);
  if (g.N < 1 || g.N > NMAX || hd == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return g.N <= NSTAGED ? launch_nm<NSTAGED, 64>(qkv, bias, mask, scal, out, g, lis, fold, grid, stamps, cta_ns, stream)
                          : launch_nm<NMID, 64>(qkv, bias, mask, scal, out, g, lis, fold, grid, stamps, cta_ns, stream);
  if (g.N <= NSTAGED) return launch_nm<NSTAGED, 32>(qkv, bias, mask, scal, out, g, lis, fold, grid, stamps, cta_ns, stream);
  if (g.N <= NMID) return launch_nm<NMID, 32>(qkv, bias, mask, scal, out, g, lis, fold, grid, stamps, cta_ns, stream);
  return launch_nm<NMAX, 32>(qkv, bias, mask, scal, out, g, lis, fold, grid, stamps, cta_ns, stream);
}

// Panel entry: W windows, nW per image (1 without a mask). Folded entry: B
// images of a res × res grid of ws × ws windows.
Geom panel_geom(int W, int N, int C, int H, int nW) { return Geom{W, nW, N, C, H, 0, 1, 0}; }
Geom folded_geom(int B, int res, int ws, int C, int H, int shift) {
  const int g = res / ws;
  return Geom{B * g * g, g * g, ws * ws, C, H, res, ws, shift};
}

template <bool LIS, bool FOLD, int NM, int HD>
cudaError_t info_of(int N, int* vals) {
  int sms = 0, per_sm = 0;
  cudaFuncAttributes fa{};
  cudaError_t err = residency<LIS, FOLD, NM, HD>(N, &sms, &per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, swin_attention_kernel<LIS, FOLD, NM, HD>);
  if (err != cudaSuccess) return err;
  const int v[5] = {layout<LIS, NM, HD>(N).total, fa.numRegs, static_cast<int>(fa.localSizeBytes), per_sm, sms};
  for (int i = 0; i < 5; ++i) vals[i] = v[i];
  return cudaSuccess;
}

template <int NM, int HD>
cudaError_t info_nm(int N, int lis, int fold, int* vals) {
  if (fold) return lis ? info_of<true, true, NM, HD>(N, vals) : info_of<false, true, NM, HD>(N, vals);
  return lis ? info_of<true, false, NM, HD>(N, vals) : info_of<false, false, NM, HD>(N, vals);
}

}  // namespace

// (W, N, 3C) window panels → (W, N, C); mask: (nW, N, N) or null (nW = 1)
extern "C" int p2v_swin_lis_attention(const void* qkv, const void* bias, const void* mask, const void* scal,
                                      void* out, int W, int N, int C, int H, int nW, int lis, void* stream) {
  if (nW < 1 || W % nW) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(qkv, bias, mask, scal, out, panel_geom(W, N, C, H, nW), lis, 0, 0, nullptr, nullptr, stream);
}

// (B, res, res, 3C) raster qkv codes → (B, res, res, C), read and written at
// pixels moved by the cyclic shift (0 ≤ shift < res); mask: (g², N, N) or null
extern "C" int p2v_swin_lis_attention_folded(const void* qkv, const void* bias, const void* mask,
                                             const void* scal, void* out, int B, int res, int ws, int C, int H,
                                             int shift, int lis, void* stream) {
  if (ws < 1 || res % ws || shift < 0 || shift >= res) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(qkv, bias, mask, scal, out, folded_geom(B, res, ws, C, H, shift), lis, 1, 0, nullptr, nullptr,
                    stream);
}

// Either entry with its measurement hooks: `grid` > 0 launches that many
// CTAs (at most one per item) instead of the plan's; `stamps` (9 × uint64,
// zeroed, or null) receives the middle CTA's %globaltimer sums over its
// items of the phases (ns): q/k/v and mask wait with the next prefetch,
// bias staging and V transpose (LIS off: v to float64), scores, LIS weights
// (LIS off: softmax and attn@v), attn@v; then the CTA's total ns, its
// items, the grid and its bias stagings; `cta_ns` (2 × grid uint64, or
// null) every CTA's start and end. Panel (fold = 0): a0 = W, a1 = N, a2 = nW; folded: a0 = B, a1 = res,
// a2 = ws.
extern "C" int p2v_swin_attention_hook(const void* qkv, const void* bias, const void* mask, const void* scal,
                                       void* out, int a0, int a1, int a2, int C, int H, int shift, int lis,
                                       int fold, int grid, void* stamps, void* cta_ns, void* stream) {
  if (fold) {
    if (a2 < 1 || a1 % a2 || shift < 0 || shift >= a1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_any(qkv, bias, mask, scal, out, folded_geom(a0, a1, a2, C, H, shift), lis, 1, grid, stamps,
                      cta_ns, stream);
  }
  if (a2 < 1 || a0 % a2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(qkv, bias, mask, scal, out, panel_geom(a0, a1, C, H, a2), lis, 0, grid, stamps, cta_ns, stream);
}

// The launch facts at N tokens and head_dim hd (32 or 64): out = {shared
// memory per CTA, registers per thread, spill (local) bytes per thread,
// CTAs per SM, SMs}.
extern "C" int p2v_swin_attention_info(int N, int hd, int lis, int fold, void* out) {
  if (N < 1 || N > NMAX || (hd != 32 && hd != 64) || (hd == 64 && N > NMAX_HD64))
    return static_cast<int>(cudaErrorInvalidValue);
  int* vals = static_cast<int*>(out);
  cudaError_t err;
  if (hd == 64)
    err = N <= NSTAGED ? info_nm<NSTAGED, 64>(N, lis, fold, vals) : info_nm<NMID, 64>(N, lis, fold, vals);
  else
    err = N <= NSTAGED ? info_nm<NSTAGED, 32>(N, lis, fold, vals)
          : N <= NMID  ? info_nm<NMID, 32>(N, lis, fold, vals)
                       : info_nm<NMAX, 32>(N, lis, fold, vals);
  return static_cast<int>(err);
}
