// Windowed int8 attention with Log-Int-Softmax, or the LIS-off fp32 softmax,
// for Swin (ops/attention_lis.py swin_lis_attention and
// swin_lis_attention_folded).
//
// Replaces the Pallas kernels p2vit_tpu/ops/attention_lis.py:swin_lis_attention
// (_swin_kernel -> _swin_head_loop) and swin_lis_attention_folded
// (_swin_folded_kernel). One block per (window, head), head_dim D = 32, N ≤ 64
// tokens per window (49 for 7×7 windows), no padding: rows and keys past N are
// never read, so nothing has to be parked out of the row max or the sum.
//
// The two entries differ only in where a window's rows live (token_of):
// p2v_swin_lis_attention reads (W, N, 3C) window panels, row i of window w at
// w·N + i; p2v_swin_lis_attention_folded reads the (B, res, res, 3C) raster
// qkv grid, row i of window (b, wy, wx) at pixel (b, wy·ws + i/ws,
// wx·ws + i%ws), and writes its output at the same pixel of (B, res, res, C).
// So window_partition and window_reverse are index arithmetic in the loads
// and the store, and the folded entry equals partition → the panel entry →
// reverse bit for bit, LIS on and off, by construction.
//
// 1. The head's q, k, v rows (N × 32 bytes each) are copied from the qkv
//    codes into shared memory, a thread per row (its address computed once,
//    two 16-byte loads), rows of 36 bytes (9 words) so that lanes reading
//    consecutive key rows hit distinct banks.
// 2. Each warp owns query rows i. Lane l holds keys l and l + 32: dp4a scores
//    → attn1 codes clip(round(acc·rq)) → clip(round((attn1·s1 + bias[h,i,j])
//    ·inv_s2)) (qact2 codes) → + mask[w mod nW, i, j] (already divided by s2,
//    added unrounded) → with LIS, p2v::lis_row (common.cuh, shared with the
//    ViT kernel): the int-exp, the exact two-limb exp_sum, integer weights
//    2^(15−q); with LIS off, p2v::softmax_row at scale s2.
// 3. attn@v: lane l is output dim l. LIS: the shift-accumulate Σ_j w_j·v[j][l]
//    in int32 over warp-shuffled weights, out = clip(round(av·2^-15·ro)).
//    LIS off: Σ_j p_j·v[j][l] in float64 (exact products), rounded once,
//    out = clip(round(av·ro)).
//
// Bound: the per-score softmax chain (an IEEE divide per score and per weight)
// and the bias/mask reads from L2 (2 × N² floats per block); the dp4a work
// is 8 instructions per score. At Swin-T batch 64, stage 0 launches
// 64·64·3 = 12,288 blocks. The folded entry reads 32-byte row pieces from
// raster rows instead of panel rows: the same bytes, no partition copies.
#include "common.cuh"

namespace {

constexpr int D = 32;
constexpr int NMAX = 64;
constexpr int JT = NMAX / 32;  // key slots per lane
constexpr int QROW = 36;       // smem bytes per q/k/v row

// Token index of row i of window `win`: the panel row, or (FOLD) the raster
// pixel of a (B, res, res) grid of ws×ws windows in (b, wy, wx) order.
template <bool FOLD>
__device__ __forceinline__ size_t token_of(int win, int i, int N, int res, int ws) {
  if constexpr (FOLD) {
    const int g = res / ws, wpi = g * g;
    const int b = win / wpi, wy = (win % wpi) / g, wx = win % g;
    return ((size_t)b * res + wy * ws + i / ws) * res + wx * ws + i % ws;
  } else {
    return (size_t)win * N + i;
  }
}

// scal: rq, s1, inv_s2, ro, x0_int, b_int, c_int, s2
template <bool LIS, bool FOLD>
__global__ void __launch_bounds__(p2v::kThreads)
    swin_attention_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, const float* __restrict__ scal,
                          int8_t* __restrict__ out, int N, int C, int H, int nW, int res, int ws) {
  __shared__ __align__(16) int8_t sm[3 * NMAX * QROW];
  const int win = blockIdx.x / H, head = blockIdx.x % H;
  // a thread per q/k/v row: its token's address once, two 16-byte loads
  const int8_t* base = qkv + head * D;
  for (int r = threadIdx.x; r < 3 * N; r += p2v::kThreads) {
    const int which = r / N, i = r % N;  // which: 0 q, 1 k, 2 v
    const uint4* src =
        reinterpret_cast<const uint4*>(base + token_of<FOLD>(win, i, N, res, ws) * 3 * C + which * C);
    uint32_t* dst = reinterpret_cast<uint32_t*>(sm + (which * NMAX + i) * QROW);
    const uint4 lo = src[0], hi = src[1];
    dst[0] = lo.x, dst[1] = lo.y, dst[2] = lo.z, dst[3] = lo.w;
    dst[4] = hi.x, dst[5] = hi.y, dst[6] = hi.z, dst[7] = hi.w;
  }
  __syncthreads();
  const int8_t* qs = sm;
  const int8_t* ks = sm + NMAX * QROW;
  const int8_t* vs = sm + 2 * NMAX * QROW;

  const float rq = scal[0], s1 = scal[1], inv_s2 = scal[2], ro = scal[3];
  const float x0 = scal[4], b_int = scal[5], c_int = scal[6];
  const float* bh = bias + (size_t)head * N * N;
  const float* mw = mask != nullptr ? mask + (size_t)(win % nW) * N * N : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < N; i += p2v::kThreads / 32) {
    uint32_t qv[D / 4];
#pragma unroll
    for (int u = 0; u < D / 4; ++u) qv[u] = p2v::ld32(qs + i * QROW + 4 * u);

    float ac[JT];
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      ac[t] = 0.f;
      if (j < N) {
        int s = 0;
#pragma unroll
        for (int u = 0; u < D / 4; ++u)
          s = __dp4a(static_cast<int>(qv[u]), static_cast<int>(p2v::ld32(ks + j * QROW + 4 * u)), s);
        const float a1 = p2v::requant(__fmul_rn(__int2float_rn(s), rq), -128.f, 127.f);
        float a2 = p2v::requant(__fmul_rn(__fadd_rn(__fmul_rn(a1, s1), bh[i * N + j]), inv_s2),
                                -128.f, 127.f);
        if (mw != nullptr) a2 = __fadd_rn(a2, mw[i * N + j]);
        ac[t] = a2;
      }
    }
    float o;
    if constexpr (LIS) {
      int wt[JT];
      p2v::lis_row<JT>(ac, N, x0, b_int, c_int, wt);
      int acc = 0;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        for (int src = 0; src < 32; ++src) {
          const int j = 32 * t + src;
          if (j >= N) break;
          const int wj = __shfl_sync(0xffffffffu, wt[t], src);
          acc += wj * static_cast<int>(vs[j * QROW + lane]);
        }
      }
      o = __fmul_rn(__fmul_rn(__int2float_rn(acc), 0x1p-15f), ro);
    } else {
      float p[JT];
      p2v::softmax_row<JT>(ac, N, scal[7], p);
      double acc = 0.0;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        for (int src = 0; src < 32; ++src) {
          const int j = 32 * t + src;
          if (j >= N) break;
          const double pj = static_cast<double>(__shfl_sync(0xffffffffu, p[t], src));
          acc = __dadd_rn(acc, __dmul_rn(pj, static_cast<double>(vs[j * QROW + lane])));
        }
      }
      o = __fmul_rn(__double2float_rn(acc), ro);
    }
    out[token_of<FOLD>(win, i, N, res, ws) * C + head * D + lane] =
        p2v::to_i8(p2v::requant(o, -128.f, 127.f));
  }
}

template <bool FOLD>
int launch_swin(const void* qkv, const void* bias, const void* mask, const void* scal, void* out,
                int W, int N, int C, int H, int nW, int res, int ws, int lis, void* stream) {
  if (W == 0) return 0;
  auto kernel = lis ? swin_attention_kernel<true, FOLD> : swin_attention_kernel<false, FOLD>;
  kernel<<<W * H, p2v::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(scal), static_cast<int8_t*>(out),
      N, C, H, nW, res, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p2v_swin_lis_attention(const void* qkv, const void* bias, const void* mask,
                                      const void* scal, void* out, int W, int N, int C, int H,
                                      int nW, int lis, void* stream) {
  return launch_swin<false>(qkv, bias, mask, scal, out, W, N, C, H, nW, 0, 1, lis, stream);
}

// (B, res, res, 3C) raster qkv codes → (B, res, res, C); mask: (g², N, N) or null
extern "C" int p2v_swin_lis_attention_folded(const void* qkv, const void* bias, const void* mask,
                                             const void* scal, void* out, int B, int res, int ws,
                                             int C, int H, int lis, void* stream) {
  const int g = res / ws;
  return launch_swin<true>(qkv, bias, mask, scal, out, B * g * g, ws * ws, C, H, g * g, res, ws,
                           lis, stream);
}
