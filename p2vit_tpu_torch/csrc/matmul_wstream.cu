// bf16 matmul over a streamed quantized weight store (ops/matmul_wstream.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/matmul_wstream.py:wstream_matmul.
//   out[m, n] = bf16([GELU](S[m, n]·r[n] + b[n]))
//   S = Σ_p fl32(A_p),  A_p = Σ_{k in panel p} x[m, k]·code[n, k]
// with the panels of the store's format (bf16 and i8: one panel of K; w8p:
// 4, w4p: 8 panels of pk words, ops/matmul_wstream.panel_len), the panel sums
// added in order p = 0..P−1, each operation rounded on its own.
//
// Numerics: every bf16 × code product has at most 16 significant bits, so
// A_p in float64 is exact, in any order, while the products of a row span
// ≤ 25 binades; fl32(A_p) then rounds once, and the kernel equals its plain
// version (a float64 matmul per panel) bit for bit. The products run on the
// float64 tensor cores (mma.sync.m16n8k16.f64, p2v::mma_f64): a DMMA that
// adds exact terms rounds nothing, in whatever order the hardware adds them.
// The sm_80 shape m8n8k4 gives the same bits at half the rate on Hopper
// (csrc/dmma_probe.cu measures both).
//
// Layout: 8 warps per block, each owning a (BM/WM)×(BN/WN) tile of m16n8
// DMMA outputs. K runs in slices of BK = 32 through a ring of STAGES
// shared-memory stages filled by 16-byte cp.async STAGES − 1 slices ahead of
// the maths, as raw bytes: x as bf16, the store as bf16, int8 or its int32
// words (2, 1 or 4 bytes a value, where a float64 tile would take 8).
// Fragments are converted to double in registers just before their DMMA:
// bf16 → float → double; integer codes → float by the 2^23 + 2^22
// magic-number subtraction (one exact FADD) → double. Two blocks share an
// SM (≤ 128 registers a thread), so one block's loads and conversions
// overlap the other's DMMAs. Inside a slice, lane (g, t) holds the 8
// consecutive values k = 8t..8t+7 of each of its rows (one 16-byte shared
// load for bf16), and DMMA step h gives values 4h..4h+3 as its k positions
// t, t+4, t+8, t+12: A and B map k the same way, and the sum is order-free,
// so this permutation of k changes no bit. With 64-byte bf16 rows and
// 32-byte int8 rows those loads are free of bank conflicts unpadded; the
// 128-byte rows of word stores are padded by 16 bytes.
//
// The block tile is chosen by M and N (pick_tile): the largest of 128×64,
// 64×64 and 32×64 that still puts a block on every SM, so M = 197 (batch 1)
// fills the card. Rows, columns and K past the matrix, and rows not 16-byte
// aligned (K % 8 ≠ 0 for bf16, K % 16 ≠ 0 for int8), are staged by element
// loads, zero-filled; slices past K (the packed stores' pad panels) are
// skipped. Bound on this card: the float64 tensor-core rate (67 TFLOP/s)
// against the bf16 tensor-core peak the bound counts: this design trades
// speed for an exact, order-free sum.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BK = 32, STAGES = 4;
enum Format { kBf16 = 0, kI8 = 1, kW8p = 2, kW4p = 3 };

// bytes of one store value in its shared tile, and the tile's row stride
template <int FMT>
struct StoreTile {
  static constexpr int VB = FMT == kBf16 ? 2 : (FMT == kI8 ? 1 : 4);
  static constexpr int LDB = BK * VB + (VB == 4 ? 16 : 0);
  static constexpr int CHUNKS = BK * VB / 16;  // 16-byte chunks per row
};

// exact int → double for |v| < 2^22: 2^23 + 2^22 + v is a float's bit
// pattern; an exact FADD removes the bias, and float → double (the
// conversion bf16 values take too) keeps the FP64 pipe free of a DADD
__device__ __forceinline__ double int_to_double(int v) {
  return static_cast<double>(__fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f));
}

// value e (0..7) of a lane's 8 consecutive bf16 values
__device__ __forceinline__ double bf16_at(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : (e < 4 ? v.y : (e < 6 ? v.z : v.w));
  return static_cast<double>(__uint_as_float(e & 1 ? (w & 0xFFFF0000u) : (w << 16)));
}

template <int FMT, int BM, int BN>
struct Tile {
  using ST = StoreTile<FMT>;
  static constexpr int LDA = BK * 2;  // 64-byte bf16 rows
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int STAGE = A_BYTES + BN * ST::LDB;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int A_CHUNKS = BM * (LDA / 16), B_CHUNKS = BN * ST::CHUNKS;

  // Stage slice t (K indices t·BK .. t·BK + BK − 1; for the packed stores
  // panel p = t·BK / pk, words j0 = t·BK − p·pk ..) into `stage`.
  __device__ static void load(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w, int M, int N,
                              int K, int pk, int m0, int n0, int t, unsigned char* stage) {
    const int k0 = t * BK;
    for (int idx = threadIdx.x; idx < A_CHUNKS + B_CHUNKS; idx += p2v::kThreads) {
      if (idx < A_CHUNKS) {
        const int r = idx >> 2, k = k0 + (idx & 3) * 8, m = m0 + r;
        unsigned char* dst = stage + r * LDA + (idx & 3) * 16;
        const __nv_bfloat16* src = x + (size_t)m * K + k;
        if (m < M && k + 8 <= K && (K & 7) == 0) {
          p2v::cp_async16(reinterpret_cast<int8_t*>(dst), reinterpret_cast<const int8_t*>(src));
        } else {
          alignas(16) uint16_t v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (m < M && k + e < K) ? reinterpret_cast<const uint16_t*>(src)[e] : uint16_t{0};
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
        continue;
      }
      const int b = idx - A_CHUNKS, r = b / ST::CHUNKS, c = b % ST::CHUNKS, n = n0 + r;
      unsigned char* dst = stage + A_BYTES + r * ST::LDB + c * 16;
      if constexpr (FMT == kW8p || FMT == kW4p) {
        // pk % 128 == 0: a slice of words never runs past the row
        const int p = k0 / pk, j = k0 - p * pk + c * 4;
        if (n < N)
          p2v::cp_async16(reinterpret_cast<int8_t*>(dst),
                          reinterpret_cast<const int8_t*>(static_cast<const uint32_t*>(w) + (size_t)n * pk + j));
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        constexpr int PER = 16 / ST::VB;  // values per chunk
        const int k = k0 + c * PER;
        const unsigned char* src = static_cast<const unsigned char*>(w) + ((size_t)n * K + k) * ST::VB;
        if (n < N && k + PER <= K && (K * ST::VB) % 16 == 0) {
          p2v::cp_async16(reinterpret_cast<int8_t*>(dst), reinterpret_cast<const int8_t*>(src));
        } else {
          alignas(16) unsigned char v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) v[e] = (n < N && k + e / ST::VB < K) ? src[e] : 0;
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
    }
  }
};

// A lane's 8 consecutive store values of one fragment row, raw
template <int FMT>
struct BRaw {
  uint4 v[FMT == kW8p || FMT == kW4p ? 2 : 1];

  __device__ __forceinline__ void load(const unsigned char* row, int t) {
    if constexpr (FMT == kBf16) {
      v[0] = *reinterpret_cast<const uint4*>(row + t * 16);
    } else if constexpr (FMT == kI8) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + t * 8);
      v[0] = make_uint4(u.x, u.y, 0, 0);
    } else {
      v[0] = *reinterpret_cast<const uint4*>(row + t * 32);
      v[1] = *reinterpret_cast<const uint4*>(row + t * 32 + 16);
    }
  }

  // value e (0..7) as double; sh: the panel's byte or nibble shift
  __device__ __forceinline__ double at(int e, int sh) const {
    if constexpr (FMT == kBf16) {
      return bf16_at(v[0], e);
    } else if constexpr (FMT == kI8) {
      const uint32_t w = e < 4 ? v[0].x : v[0].y;
      return int_to_double(static_cast<int8_t>(w >> (8 * (e & 3))));
    } else {
      const uint4& q = v[e >> 2];
      const uint32_t w = (e & 3) == 0 ? q.x : ((e & 3) == 1 ? q.y : ((e & 3) == 2 ? q.z : q.w));
      if constexpr (FMT == kW8p) return int_to_double(static_cast<int8_t>(w >> sh));
      return int_to_double((static_cast<int>((w >> sh) & 0xFu) ^ 8) - 8);
    }
  }
};

template <int FMT, int P, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(p2v::kThreads, 2)
    wstream_matmul_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                          const float* __restrict__ r, const float* __restrict__ b,
                          __nv_bfloat16* __restrict__ out, int M, int N, int K, int pk, int gelu) {
  using TL = Tile<FMT, BM, BN>;
  constexpr int WTM = BM / WM, WTN = BN / WN, MT = WTM / 8, NT = WTN / 8;
  static_assert(WM * WN * 32 == p2v::kThreads && WTM % 16 == 0 && WTN % 8 == 0, "8 warps of m16n8 tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  // acc[i][j]: the 8×8 output block at warp rows 8i + g, columns 8j + 2·t4;
  // rows i and i + 1 (i even) form one m16n8 tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  double acc[MT][NT][2];
  float s[MT][NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[i][j][e] = 0.0, s[i][j][e] = 0.f;

  // Σ_p fl32(A_p) in panel order: round the panel's exact sum once, add it
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[i][j][e] = __fadd_rn(s[i][j][e], __double2float_rn(acc[i][j][e]));
          acc[i][j][e] = 0.0;
        }
  };

  const int T = (K + BK - 1) / BK;  // slices; the packed stores' pad panels have none
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < T) TL::load(x, w, M, N, K, pk, m0, n0, st, smem + st * TL::STAGE);
    p2v::cp_async_commit();
  }
  int p = 0;
  for (int t = 0; t < T; ++t) {
    p2v::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {  // refill the stage every warp finished reading before the barrier
      const int nt = t + STAGES - 1;
      if (nt < T) TL::load(x, w, M, N, K, pk, m0, n0, nt, smem + (nt % STAGES) * TL::STAGE);
      p2v::cp_async_commit();
    }
    const unsigned char* sa = smem + (t % STAGES) * TL::STAGE;
    const unsigned char* sb = sa + TL::A_BYTES;
    const int sh = FMT == kW8p ? 8 * p : 4 * p;
    uint4 araw[MT];
    BRaw<FMT> braw[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      araw[i] = *reinterpret_cast<const uint4*>(sa + (wm * WTM + i * 8 + g) * TL::LDA + t4 * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) braw[j].load(sb + (wn * WTN + j * 8 + g) * StoreTile<FMT>::LDB, t4);
    // two m16n8k16 steps per slice: step h takes each lane's values 4h..4h+3
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double a[MT][4], c[NT][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < MT; ++i) a[i][q] = bf16_at(araw[i], 4 * h + q);
#pragma unroll
        for (int j = 0; j < NT; ++j) c[j][q] = braw[j].at(4 * h + q, sh);
      }
#pragma unroll
      for (int i = 0; i < MT; i += 2)
#pragma unroll
        for (int j = 0; j < NT; ++j) p2v::mma_f64(acc[i][j], acc[i + 1][j], a[i], a[i + 1], c[j]);
    }
    if constexpr (P > 1) {
      const int np = (t + 1) * BK / pk;
      if (t + 1 < T && np != p) {
        flush();
        p = np;
      }
    }
  }
  // Panels past the last slice (all pad) add +0 in the plain version, which
  // changes nothing: s starts at +0 and no panel sum is −0.
  flush();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + wm * WTM + i * 8 + g, n = n0 + wn * WTN + j * 8 + 2 * t4 + e;
        if (m >= M || n >= N) continue;
        float y = __fadd_rn(__fmul_rn(s[i][j][e], r[n]), b[n]);
        if (gelu) y = p2v::gelu_as(y);
        out[(size_t)m * N + n] = __float2bfloat16_rn(y);
      }
}

// Block tiles, largest first: BM × BN outputs over WM × WN warps
struct TileShape {
  int bm, bn, wm, wn;
};
constexpr TileShape kTiles[] = {{128, 64, 4, 2}, {64, 64, 2, 4}, {32, 64, 2, 4}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

int blocks_of(int v, int M, int N) {
  return ((N + kTiles[v].bn - 1) / kTiles[v].bn) * ((M + kTiles[v].bm - 1) / kTiles[v].bm);
}

// the largest tile that puts a block on every SM, else the smallest
int pick_tile(int M, int N) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  for (int v = 0; v < kNumTiles; ++v)
    if (blocks_of(v, M, N) >= sms) return v;
  return kNumTiles - 1;
}

template <int FMT, int P, int V>
cudaError_t launch_tile(const void* x, const void* w, const void* r, const void* b, void* out, int M, int N,
                        int K, int pk, int gelu, cudaStream_t stream) {
  constexpr int BM = kTiles[V].bm, BN = kTiles[V].bn;
  constexpr int smem = Tile<FMT, BM, BN>::SMEM;
  auto kern = wstream_matmul_kernel<FMT, P, BM, BN, kTiles[V].wm, kTiles[V].wn>;
  cudaError_t err = p2v::set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, p2v::kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x), w,
                                              static_cast<const float*>(r), static_cast<const float*>(b),
                                              static_cast<__nv_bfloat16*>(out), M, N, K, pk, gelu);
  return cudaGetLastError();
}

template <int FMT, int P>
cudaError_t launch(const void* x, const void* w, const void* r, const void* b, void* out, int M, int N, int K,
                   int pk, int gelu, cudaStream_t stream) {
  switch (pick_tile(M, N)) {
    case 0: return launch_tile<FMT, P, 0>(x, w, r, b, out, M, N, K, pk, gelu, stream);
    case 1: return launch_tile<FMT, P, 1>(x, w, r, b, out, M, N, K, pk, gelu, stream);
    default: return launch_tile<FMT, P, 2>(x, w, r, b, out, M, N, K, pk, gelu, stream);
  }
}

}  // namespace

// x (M, K) bf16; w the store of format fmt (0 bf16 (N, K), 1 int8 (N, K),
// 2 w8p / 3 w4p int32 (N, pk)); r, b (N,) float32; out (M, N) bf16.
extern "C" int p2v_wstream_matmul(const void* x, const void* w, const void* r, const void* b, void* out,
                                  int M, int N, int K, int pk, int fmt, int gelu, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K > 0 && (pk <= 0 || pk % 128 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt) {
    case kBf16: err = launch<kBf16, 1>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    case kI8: err = launch<kI8, 1>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    case kW8p: err = launch<kW8p, 4>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    case kW4p: err = launch<kW4p, 8>(x, w, r, b, out, M, N, K, pk, gelu, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// the number of blocks p2v_wstream_matmul launches for (M, N)
extern "C" int p2v_wstream_matmul_blocks(int M, int N) {
  if (M == 0 || N == 0) return 0;
  return blocks_of(pick_tile(M, N), M, N);
}
