// The Hopper int8 GEMM tile with the PoT requant epilogue: TMA loads into an
// mbarrier ring, wgmma s8·s8 → s32, a persistent, warp-specialized grid.
//
// Replaces the Pallas kernel p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant
// (_kernel). out[m, n] = requant_epilogue(Σ_k x[m, k]·w[n, k], r[n], b[n]);
// the int32 sum is exact in any order, so the tiling changes no bit, and the
// epilogue is p2v::requant_epilogue, the same function as the fused layer's.
//
// Bound on the H100: the bytes of x and out at the narrow Swin layers, and
// at fc1 the GELU epilogue, ~128 instructions an element (its float64 exp
// about half), which the SMs issue at most 4 warp instructions a clock; the
// int8 products are cheap. The design keeps the tensor cores and the
// epilogue arithmetic busy at once:
// * tiles sized to N: a consumer owns a 64 × BN output tile, one
//   wgmma.m64nBNk32 per 32 bytes of K; the plan picks BN from kWidths to
//   waste the fewest columns (N = 96 → 96, 288 → 144, 1000 → 144, masked);
// * a producer thread issues cp.async.bulk.tensor (TMA) loads of 64 x rows
//   and BN w rows, 128 bytes of K each, into a ring of stages with
//   full/empty mbarriers; the boxes are 128-byte swizzled, as the wgmma
//   descriptors read them, and TMA fills zeros past M, N and K (zeros add
//   nothing to the exact sum);
// * consumer warpgroups take a CTA's tiles in turn, their main loops in
//   order, so while one issues its wgmmas the others run their epilogues;
//   setmaxnreg moves registers from the producer warpgroup to them;
// * the grid is persistent (one CTA per SM) and walks the tiles M-outer, so
//   each x row block comes from HBM once while the weights stay in L2;
// * the plain epilogue works on the accumulator registers, with r and b
//   staged in shared memory once per tile and the rounding done by adds
//   (rint_clip); the GELU epilogue has narrow tiles (BN 64) and six
//   consumers, and runs from the int32 tile in shared memory in a rolled
//   loop that stays in the instruction cache;
// * the int8 tile is written to shared memory, then stored with coalesced
//   16-byte stores (8, 4 or 1 where N is not a multiple of 16).
// The plan (RequantPlan; ops/matmul_int8.requant_plan mirrors it) picks BN
// and the consumers, the ring depth from shared memory, and the grid.
//
// The same body serves the int4-packed store (PACKED; replaces the Pallas
// kernel p2vit_tpu/ops/matmul_int8.py:int4_matmul_requant, _packed_kernel):
// pack_int4's (N, K/2) bytes, byte j of row n holding w[n, j] in its low
// nibble and w[n, K/2 + j] in its high one, kh = K/2 a multiple of 16.
// * A ring stage holds one 64-byte box of the packed store (BN rows) and
//   the two x boxes it multiplies, at columns s·64 and kh + s·64: 128 codes
//   of K a stage, as the int8 store's stage, in as many bytes (the unpacked
//   tiles), and half its weight bytes read from HBM. The boxes are 64-byte
//   swizzled, as the wgmma descriptors read them. TMA coordinates need no
//   alignment, and zeros fill past kh in the packed box: a zero byte
//   unpacks to two zero codes, so the x columns that the low box reads past
//   kh (the high half's) multiply zeros. No padding and no masking past the
//   wrapper's 16.
// * Warps 1–3 of the producer warpgroup unpack each packed box once it has
//   landed (its own barrier): in the swizzle a 16-byte chunk of the packed
//   box and its two unpacked int8 chunks sit at the same offset of their
//   tiles, so chunk i of the box becomes chunk i of the low B tile (in
//   place) and of the high one, no swizzle arithmetic. They fence their
//   writes to the async proxy and arrive on the stage's full barrier, which
//   the x boxes' bytes complete beside them.
// * The consumer issues the low slice's wgmmas, then the high slice's, on
//   the same accumulators; the epilogue is the int8 store's, so the two
//   stores give the same codes. Where |qmin| or |qmax| exceeds kMaxCode
//   (beyond rint_clip), the tile rounds with requant (rintf, then the clip)
//   and converts to int8 as the plain version does.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the library links no libcuda)

#include "matmul_tiles.cuh"

namespace p2v {
namespace wg {

constexpr int kBM = 64;                // output rows per consumer tile: one m64 wgmma
constexpr int kBK = 128;               // K bytes per ring stage: the 128-byte swizzle span
constexpr int kPBK = 64;               // packed store: bytes of a B row per stage, the 64-byte swizzle span
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;       // dynamic shared memory one block may use
constexpr int kMaxCode = 1 << 22;      // |qmin|, |qmax| bound of rint_clip

// A tile width BN (a legal m64nNk32 width) and the consumer warpgroups that
// share a CTA at that width. The GELU epilogue runs from an int32 tile in
// shared memory, so its tiles are narrow (six such tiles fit beside the
// ring) and its consumers many (more warps to issue from).
struct Width {
  int bn, nc;
};
constexpr Width kWidths[] = {{256, 2}, {192, 2}, {144, 2}, {128, 2}, {96, 2}};
constexpr Width kGeluWidths[] = {{64, 6}};

struct RequantPlan {
  int bn, nc, stages, tiles_m, tiles_n, grid, smem;
};

constexpr int threads_of(int nc) { return 128 * (nc + 1); }  // warpgroup 0 produces
constexpr int kUnpackers = 96;  // the packed store's unpacking threads: producer warps 1–3

// A ring stage: the int8 store's 64 x rows and BN w rows of 128 bytes; the
// packed store's two x boxes of 64 rows, its packed box of BN rows
// (unpacked in place into the low B tile) and the high B tile, 64 bytes
// each: the same bytes.
__host__ __device__ constexpr int ring_stage_bytes(int bn) { return (kBM + bn) * kBK; }

// Shared memory: 1024 B of alignment slack, the ring, a 64 × (BN + 16)
// output tile and r and b per consumer, with GELU a 64 × (BN + 8) int32
// accumulator tile per consumer, a full and an empty barrier per stage (and
// the packed box's), and an order barrier per consumer.
inline int requant_smem(int bn, int nc, int stages, bool gelu, bool packed = false) {
  return 1024 + stages * ring_stage_bytes(bn) + nc * kBM * (bn + 16) + nc * 8 * bn +
         (gelu ? nc * kBM * (bn + 8) * 4 : 0) + (packed ? 24 : 16) * stages + 8 * nc;
}

// The launch plan at (M, N) on a card of `sms` SMs (any K % 16 == 0; for
// the packed store K/2 % 16 == 0). BN: the width that wastes the fewest
// columns, ⌈N/BN⌉·BN − N, the widest on a tie.
inline RequantPlan requant_plan(int M, int N, int sms, bool gelu, bool packed = false) {
  RequantPlan p{};
  const Width* ws = gelu ? kGeluWidths : kWidths;
  const int nw = gelu ? sizeof(kGeluWidths) / sizeof(Width) : sizeof(kWidths) / sizeof(Width);
  long long waste = -1;
  for (int i = 0; i < nw; ++i) {
    const long long x = (long long)((N + ws[i].bn - 1) / ws[i].bn) * ws[i].bn - N;
    if (waste < 0 || x < waste) waste = x, p.bn = ws[i].bn, p.nc = ws[i].nc;
  }
  p.stages =
      (kMaxSmem - requant_smem(p.bn, p.nc, 0, gelu, packed)) / (ring_stage_bytes(p.bn) + (packed ? 24 : 16));
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.tiles_m = (M + kBM - 1) / kBM;
  p.tiles_n = (N + p.bn - 1) / p.bn;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  p.grid = static_cast<int>(tiles < sms ? tiles : sms);
  p.smem = requant_smem(p.bn, p.nc, p.stages, gelu, packed);
  return p;
}

// ---- host helpers -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so that the library links no libcuda; null where it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The TMA map of a (rows, K) int8 matrix, boxes of 128 K bytes × box_rows,
// 128-byte swizzle (box_k 64: 64 bytes, 64-byte swizzle), zeros outside the
// matrix; no L2 promotion (256-byte promotion slowed the rows of K < 128
// bytes).
inline bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows, int box_k = kBK) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = box_k == kPBK ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device (cached per device)
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int cache[64] = {};
  if (dev < 64 && cache[dev]) return cache[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cache[dev] = sms;
  return sms;
}

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 innermost, c1) into shared memory; its bytes
// complete the transaction count of `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows written
// by TMA with the 128-byte swizzle: start address >> 4, stride 1024 B between
// 8-row groups, layout 1 (SWIZZLE_128B). The tile is 1024-byte aligned, so
// adding 32·j bytes (2·j in the address field) selects the j-th 32-byte K step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for a tile of 64-byte rows written with the 64-byte swizzle:
// stride 512 B between 8-row groups, layout 2 (SWIZZLE_64B); 512-byte
// aligned, 32·j bytes select the j-th 32-byte K step.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a fence
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d(64 × N, s32) += A(64 × 32, s8) · B(N × 32, s8)ᵀ, both K-major in shared
// memory; accumulate = 0 overwrites d. One overload per width of kWidths:
// the instruction names every accumulator register.

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[48], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47} "
      ", %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63} "
      ", %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[72], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71} "
      ", %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95} "
      ", %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "
      "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127} "
      ", %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]),
        "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]),
        "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- whole-row code tiles, split over a cluster ------------------------------

// A row's partial sums over one CTA's columns, as its cluster peers read them.
struct RowSums {
  long long sxx;
  int sx, pad;
};

// Bytes between two rows of a code tile: the chunks' width plus a pad that
// puts the eight rows a quad group writes in distinct banks.
__host__ __device__ constexpr int code_ld(int nw) { return nw + ((nw / 4) % 8 == 0 ? 16 : 32); }

// The plan of a whole-row kernel (csrc/matmul_ln.cu, csrc/embed_fused.cu)
// at (M, N), N % 16 == 0, given resident[cs - 1], the clusters of cs CTAs
// the card holds at once (one CTA per SM: every plan fills shared memory
// past half an SM's): clusters of CS CTAs split N, CTA r of a cluster taking
// chunks [r·cpc, (r + 1)·cpc) of BN columns (BN from widths); each cluster
// takes row blocks of 64·NC rows in turn. For each CS (1 to 4), BN and cpc
// waste the fewest columns, ⌈N/(CS·BN)⌉·CS·BN − N (the widest BN on a
// tie); where CS = 1 fits (some NC with two ring stages), a CS > 1 that
// wastes more than CS = 1 does is skipped; where it does not (a whole row's
// code tile leaves no room for two stages), the clusters need not beat its
// waste. Of the (CS, NC) that fit with two ring stages or more, the plan
// takes the one whose busiest consumer owns the fewest elements,
// ⌈blocks/resident⌉·64·cpc·BN (the epilogue's time: the consumers' warps
// issue it side by side), then the smaller CS, then the smaller NC; the
// ring takes as many stages as shared memory holds, up to kMaxStages.
// smem(bn, cpc, nc, stages, cs) is the kernel's shared memory; force_cs,
// force_nc > 0 restrict the choice (a measurement hook).
constexpr int kRowMaxConsumers = 2;
constexpr int kRowMaxCluster = 4;

struct RowPlan {
  int bn, cpc, cs, nc, stages, blocks, grid, smem;  // nc = 0: N does not fit shared memory
};

template <class Smem>
inline RowPlan whole_row_plan(int M, int N, const int* widths, int nwidths, Smem smem, const int* resident,
                              int force_cs = 0, int force_nc = 0) {
  auto stages_of = [&](int bn, int cpc, int nc, int cs) {
    const int st = (kMaxSmem - smem(bn, cpc, nc, 0, cs)) / ((kBM * nc + bn) * kBK + 16);
    return st < kMaxStages ? st : kMaxStages;
  };
  RowPlan best{};
  long long best_load = -1, waste1 = -1;
  for (int cs = 1; cs <= kRowMaxCluster; ++cs) {
    int bn = 0, cpc = 0;
    long long waste = -1;
    for (int i = 0; i < nwidths; ++i) {
      const int k = (N + cs * widths[i] - 1) / (cs * widths[i]);
      const long long x = (long long)cs * k * widths[i] - N;
      if (waste < 0 || x < waste) waste = x, bn = widths[i], cpc = k;
    }
    if (cs == 1) {  // CS = 1's waste bounds the clusters' only where CS = 1 fits
      bool fits = false;
      for (int nc = 1; nc <= kRowMaxConsumers; ++nc) fits = fits || stages_of(bn, cpc, nc, 1) >= 2;
      waste1 = fits ? waste : -1;
    }
    if ((waste1 >= 0 && waste > waste1) || resident[cs - 1] < 1 || (force_cs && cs != force_cs)) continue;
    for (int nc = kRowMaxConsumers; nc >= 1; --nc) {
      if (force_nc && nc != force_nc) continue;
      const int stages = stages_of(bn, cpc, nc, cs);
      if (stages < 2) continue;
      const long long blocks = ((long long)M + kBM * nc - 1) / (kBM * nc), clusters = resident[cs - 1];
      const long long load = (blocks + clusters - 1) / clusters * kBM * cpc * bn;
      if (best_load < 0 || load < best_load || (load == best_load && cs == best.cs && nc < best.nc)) {
        best_load = load;
        best.bn = bn, best.cpc = cpc, best.cs = cs, best.nc = nc, best.stages = stages;
        best.blocks = static_cast<int>(blocks);
        best.grid = static_cast<int>(blocks < clusters ? blocks : clusters) * cs;
      }
    }
  }
  if (best.nc != 0) best.smem = smem(best.bn, best.cpc, best.nc, best.stages, best.cs);
  return best;
}

// ---- cluster helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// shared::cluster address of `p` (this CTA's shared memory) in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// arrive on the barrier at `bar` in CTA `rank`, releasing this thread's
// earlier writes to the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(peer_addr(bar, rank))
               : "memory");
}

// mbar_wait, acquiring what the arriving peers released
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ RowSums ld_peer(const RowSums* p, uint32_t rank) {
  const uint32_t a = peer_addr(p, rank);
  RowSums v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v.sxx) : "r"(a) : "memory");
  asm volatile("ld.shared::cluster.u32 %0, [%1+8];\n" : "=r"(v.sx) : "r"(a) : "memory");
  v.pad = 0;
  return v;
}

// ---- the epilogue ---------------------------------------------------------------

// requant_epilogue's code as an int: the same float chain (gelu_as
// unchanged), its rounding and clip by p2v::rint_clip (matmul_tiles.cuh).
__device__ __forceinline__ int requant_code(int acc, float r, float b, float out_inv, bool gelu, float lo,
                                            float hi) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), r), b);
  if (gelu) y = __fmul_rn(gelu_as(y), out_inv);
  return rint_clip(y, lo, hi);
}

// The code where |lo| or |hi| exceeds kMaxCode, past rint_clip's range:
// requant_epilogue's rintf, then the clip, then the float → int8 conversion
// of the plain version's .to(int8) on the card.
template <bool WIDE>
__device__ __forceinline__ int tile_code(int acc, float r, float b, float out_inv, bool gelu, float lo, float hi) {
  if constexpr (WIDE) {
    return static_cast<int8_t>(requant_epilogue(acc, r, b, out_inv, gelu, lo, hi));
  } else {
    return requant_code(acc, r, b, out_inv, gelu, lo, hi);
  }
}

// The junction on one chunk's accumulators (the whole-row kernels of
// csrc/matmul_ln.cu and csrc/layer_fused.cu): thread (w, l) holds
// acc[4j + 2h + e] at row g + 8h of its warp's rows (g = l/4), column
// n0 + 8j + 2q + e (q = l%4). The residual code in the tile is read and
// replaced by the new one; x = code·mask goes into the row sums.
template <int BN>
__device__ __forceinline__ void junction_chunk(const int (&acc)[BN / 2], int8_t* ct, int ldc, int n0, const float* vs,
                                               int nw, int g, int q, float lo, float hi, int (&sx)[2],
                                               long long (&sxx)[2]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    const float2 r = *reinterpret_cast<const float2*>(vs + col);
    const float2 b = *reinterpret_cast<const float2*>(vs + nw + col);
    const float2 sm = *reinterpret_cast<const float2*>(vs + 2 * nw + col);
    const float2 sr = *reinterpret_cast<const float2*>(vs + 3 * nw + col);
    const float2 inv = *reinterpret_cast<const float2*>(vs + 4 * nw + col);
    const float2 mk = *reinterpret_cast<const float2*>(vs + 5 * nw + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint16_t* p = reinterpret_cast<uint16_t*>(ct + (g + 8 * h) * ldc + col);
      const uint32_t rr = *p;  // the two residual codes
      const float t0 = junction_code(acc[4 * j + 2 * h], r.x, b.x, sm.x, __int2float_rn(static_cast<int8_t>(rr)),
                                     sr.x, inv.x, lo, hi);
      const float t1 = junction_code(acc[4 * j + 2 * h + 1], r.y, b.y, sm.y,
                                     __int2float_rn(static_cast<int8_t>(rr >> 8)), sr.y, inv.y, lo, hi);
      *p = static_cast<uint16_t>(code_byte(t0) | (code_byte(t1) << 8));
      const int x0 = __float2int_rz(__fmul_rn(unbias(t0), mk.x)), x1 = __float2int_rz(__fmul_rn(unbias(t1), mk.y));
      sx[h] += x0 + x1;
      sxx[h] += static_cast<long long>(x0) * x0;
      sxx[h] += static_cast<long long>(x1) * x1;
    }
  }
}

// ---- the kernel ---------------------------------------------------------------

// Thread (warp w of the warpgroup, lane l) holds d[4j + 2h + e] of the
// 64 × BN tile at row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
template <int BN, bool WIDE = false>
__device__ __forceinline__ void requant_epilogue_tile(const int (&acc)[BN / 2], const float* rs, const float* bs,
                                                      int8_t* ot, float out_inv, float lo, float hi) {
  constexpr int LD = BN + 16;
  const int t = threadIdx.x & 127, w = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 rr = *reinterpret_cast<const float2*>(rs + c);
    const float2 bb = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = tile_code<WIDE>(acc[4 * j + 2 * h], rr.x, bb.x, out_inv, false, lo, hi);
      const int c1 = tile_code<WIDE>(acc[4 * j + 2 * h + 1], rr.y, bb.y, out_inv, false, lo, hi);
      *reinterpret_cast<uint16_t*>(ot + (16 * w + g + 8 * h) * LD + c) =
          static_cast<uint16_t>((c0 & 0xFF) | ((c1 & 0xFF) << 8));
    }
  }
}

// The GELU epilogue from the int32 tile in shared memory, two elements per
// trip of a rolled loop: every element is a chain of ~125 instructions (the
// float64 exp and the IEEE divide each end in a branch, so the compiler
// cannot interleave two), and a trip's code stays in the instruction cache
// that an unrolled tile's (~70 KB) overran. Each thread keeps one column,
// so r and b stay in registers.
template <int BN, bool WIDE = false>
__device__ __forceinline__ void gelu_epilogue_tile(const int* sacc, const float* rs, const float* bs, int8_t* ot,
                                                   float out_inv, float lo, float hi) {
  static_assert(128 % BN == 0, "a thread keeps one column");
  constexpr int LD = BN + 16, LDA = BN + 8;
  const int t = threadIdx.x & 127, col = t % BN, row = t / BN;
  const float r = rs[col], b = bs[col];
  const int* src = sacc + row * LDA + col;
  int8_t* dst = ot + row * LD + col;
#pragma unroll 2
  for (int i = 0; i < kBM * BN / 128; ++i, src += 128 / BN * LDA, dst += 128 / BN * LD)
    *dst = static_cast<int8_t>(tile_code<WIDE>(*src, r, b, out_inv, true, lo, hi));
}

// The tile's rows and columns inside out[M, N], V bytes at a time (N % V == 0).
template <int BN, int V>
__device__ __forceinline__ void store_tile(const int8_t* ot, int8_t* out, int M, int N, int m0, int n0) {
  using Vec = typename std::conditional<
      V == 16, int4,
      typename std::conditional<V == 8, int2, typename std::conditional<V == 4, int, int8_t>::type>::type>::type;
  constexpr int LD = BN + 16, CPR = BN / V;
  for (int idx = threadIdx.x & 127; idx < kBM * CPR; idx += 128) {
    const int row = idx / CPR, col = (idx % CPR) * V;
    if (m0 + row < M && n0 + col < N)
      *reinterpret_cast<Vec*>(out + (size_t)(m0 + row) * N + n0 + col) =
          *reinterpret_cast<const Vec*>(ot + row * LD + col);
  }
}

// Registers per thread: the launch gives each of the 128·(NC + 1) threads
// kLaunch; the producer warpgroup keeps kProducer and hands the rest to the
// consumers, kConsumer each (setmaxnreg, multiples of 8).
template <int NC>
struct Regs {
  static constexpr int kLaunch = (65536 / threads_of(NC)) & ~7;
  static constexpr int kProducer = NC == 2 ? 40 : 24;
  static constexpr int kConsumer = (kLaunch + (kLaunch - kProducer) / NC) & ~7;
  static_assert(kConsumer <= 256 && 128 * kProducer + NC * 128 * kConsumer <= threads_of(NC) * kLaunch, "");
};

// The packed box of a stage unpacked by the kUnpackers threads u: 16-byte
// chunk i of the box (bytes j of a row, two codes each) becomes chunk i of
// the low B tile, in place, and of the high one; the same swizzled offset
// in all three tiles holds the same row and chunk.
template <int BN>
__device__ __forceinline__ void unpack_box(uint8_t* box, int u) {
  constexpr int kChunks = BN * kPBK / 16;
  uint4* lo = reinterpret_cast<uint4*>(box);
  uint4* hi = lo + kChunks;
#pragma unroll 1
  for (int i = u; i < kChunks; i += kUnpackers) {
    const uint4 v = lo[i];
    lo[i] = make_uint4(nib_sext(v.x & 0x0F0F0F0Fu), nib_sext(v.y & 0x0F0F0F0Fu), nib_sext(v.z & 0x0F0F0F0Fu),
                       nib_sext(v.w & 0x0F0F0F0Fu));
    hi[i] = make_uint4(nib_sext((v.x >> 4) & 0x0F0F0F0Fu), nib_sext((v.y >> 4) & 0x0F0F0F0Fu),
                       nib_sext((v.z >> 4) & 0x0F0F0F0Fu), nib_sext((v.w >> 4) & 0x0F0F0F0Fu));
  }
}

// out = the requant epilogue of x (M, K) · Bᵀ: B the int8 store w (N, K)
// through tmw, or (PACKED) pack_int4's (N, K/2) store through tmw, x read at
// both halves. wide (PACKED only): |qmin| or |qmax| > kMaxCode.
template <int BN, int NC, bool GELU, bool PACKED>
__global__ void __launch_bounds__(threads_of(NC), 1)
    requant_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                   const float* __restrict__ r, const float* __restrict__ b, const float* __restrict__ scal,
                   int8_t* __restrict__ out, int M, int N, int K, int stages, float lo, float hi, int wide) {
  constexpr int STAGE = ring_stage_bytes(BN), LD = BN + 16;
  constexpr int SK = PACKED ? kPBK : kBK;  // bytes of a B row a stage: codes, or packed pairs
  constexpr int XB = (PACKED ? 2 : 1) * kBM * SK;  // the x boxes' bytes in a stage, before B
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* otiles = reinterpret_cast<int8_t*>(smem + stages * STAGE);
  float* rb = reinterpret_cast<float*>(otiles + NC * kBM * LD);
  int* accs = reinterpret_cast<int*>(rb + 2 * NC * BN);  // GELU: the int32 tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(accs + (GELU ? NC * kBM * (BN + 8) : 0));
  uint64_t* empty = full + stages;
  uint64_t* order = empty + stages;  // one per consumer: its main loop of a tile is done
  uint64_t* pfull = order + NC;      // PACKED: the packed box of a stage has landed

  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int kw = PACKED ? K / 2 : K;  // K bytes of a B row: codes, or packed pairs
  const int nk = (kw + SK - 1) / SK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, PACKED ? 1 + kUnpackers : 1);
      mbar_init(empty + s, 1);
      if constexpr (PACKED) mbar_init(pfull + s, 1);
    }
    for (int c = 0; c < NC; ++c) mbar_init(order + c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs<NC>::kProducer));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmw)) : "memory");
      int pos = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
        for (int s = 0; s < nk; ++s, ++pos) {
          const int st = pos % stages;
          uint8_t* base = smem + st * STAGE;
          mbar_wait(empty + st, ((pos / stages) & 1) ^ 1);
          if constexpr (PACKED) {
            mbar_expect_tx(full + st, XB);
            mbar_expect_tx(pfull + st, BN * SK);
            tma_load_2d(base, &tmx, s * SK, m0, full + st);
            tma_load_2d(base + kBM * SK, &tmx, kw + s * SK, m0, full + st);
            tma_load_2d(base + XB, &tmw, s * SK, n0, pfull + st);
          } else {
            mbar_expect_tx(full + st, STAGE);
            tma_load_2d(base, &tmx, s * kBK, m0, full + st);
            tma_load_2d(base + XB, &tmw, s * kBK, n0, full + st);
          }
        }
      }
    } else if constexpr (PACKED) {
      // ---- unpackers: each packed box into the stage's two B tiles ----------
      if (threadIdx.x >= 32) {
        int pos = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x)
          for (int s = 0; s < nk; ++s, ++pos) {
            const int st = pos % stages;
            mbar_wait(pfull + st, (pos / stages) & 1);
            unpack_box<BN>(smem + st * STAGE + XB, threadIdx.x - 32);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmmas
            mbar_arrive(full + st);
          }
      }
    }
  } else {
    // ---- consumers: warpgroup c takes the CTA's tiles c, c + NC, … ----------
    // Their main loops run in turn (order barriers): a consumer waits for
    // ring position p only once every earlier position has been consumed, so
    // a full barrier is never more than one phase behind the parity it tests.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs<NC>::kConsumer));
    const int c = (threadIdx.x >> 7) - 1, t128 = threadIdx.x & 127;
    const int prev = c == 0 ? NC - 1 : c - 1;
    int8_t* ot = otiles + c * kBM * LD;
    float* rs = rb + 2 * c * BN;
    float* bs = rs + BN;
    const float out_inv = scal[0];
    const int vec = N % 16 == 0 ? 16 : N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : 1;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // r and b of the next tile, loaded a tile ahead (BN ≤ 256: two columns a thread)
    float rn[2], bn[2];
    auto fetch = [&](int t) {
      const int n0 = (t % tiles_n) * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t128 + 128 * h;
        const bool in = col < BN && t < tiles && n0 + col < N;
        rn[h] = in ? r[n0 + col] : 0.f;
        bn[h] = in ? b[n0 + col] : 0.f;
      }
    };
    fetch(blockIdx.x + c * gridDim.x);
    for (int i = c, t = blockIdx.x + c * gridDim.x; t < tiles; i += NC, t += NC * gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (t128 + 128 * h < BN) rs[t128 + 128 * h] = rn[h], bs[t128 + 128 * h] = bn[h];
      fetch(t + NC * gridDim.x);
      if (i > 0) mbar_wait(order + prev, ((i - 1) / NC) & 1);
      // main loop: one ring stage per 128 bytes of a B row, one slice's wgmmas in flight
      for (int s = 0; s < nk; ++s) {
        const int pos = i * nk + s, st = pos % stages;
        mbar_wait(full + st, (pos / stages) & 1);
        const uint32_t a = smem_u32(smem + st * STAGE);
        const uint64_t da = PACKED ? sw64_desc(a) : sw128_desc(a);
        const uint64_t db = PACKED ? sw64_desc(a + XB) : sw128_desc(a + XB);
        const int ksteps = (min(SK, kw - s * SK) + 31) / 32;
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < SK / 32; ++kk)
          if (kk < ksteps) wgmma_s8(acc, da + 2 * kk, db + 2 * kk, s + kk);
        if constexpr (PACKED) {  // the high half: x at kh + s·64 against the high B tile
          const uint64_t dah = sw64_desc(a + kBM * SK), dbh = sw64_desc(a + XB + BN * SK);
#pragma unroll
          for (int kk = 0; kk < SK / 32; ++kk)
            if (kk < ksteps) wgmma_s8(acc, dah + 2 * kk, dbh + 2 * kk, 1);
        }
        wgmma_commit();
        fence_regs(acc);
        if (s > 0) {
          wgmma_wait<1>();
          if (t128 == 0) mbar_arrive(empty + (pos - 1) % stages);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t128 == 0) {
        mbar_arrive(empty + (i * nk + nk - 1) % stages);
        mbar_arrive(order + c);
      }

      if constexpr (GELU) {
        constexpr int LDA = BN + 8;
        int* sacc = accs + c * kBM * LDA;
        const int w = t128 >> 5, g = (t128 & 31) >> 2, q = t128 & 3;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(sacc + (16 * w + g + 8 * h) * LDA + 8 * j + 2 * q) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        named_sync(1 + c, 128);  // acc, r, b staged; the last tile's stores have read ot
        if (PACKED && wide)
          gelu_epilogue_tile<BN, PACKED>(sacc, rs, bs, ot, out_inv, lo, hi);
        else
          gelu_epilogue_tile<BN, false>(sacc, rs, bs, ot, out_inv, lo, hi);
      } else {
        named_sync(1 + c, 128);  // r, b staged; the last tile's stores have read ot
        if (PACKED && wide)
          requant_epilogue_tile<BN, PACKED>(acc, rs, bs, ot, out_inv, lo, hi);
        else
          requant_epilogue_tile<BN, false>(acc, rs, bs, ot, out_inv, lo, hi);
      }
      named_sync(1 + c, 128);  // ot written; r, b (and acc) read
      if (vec == 16)
        store_tile<BN, 16>(ot, out, M, N, m0, n0);
      else if (vec == 8)
        store_tile<BN, 8>(ot, out, M, N, m0, n0);
      else if (vec == 4)
        store_tile<BN, 4>(ot, out, M, N, m0, n0);
      else
        store_tile<BN, 1>(ot, out, M, N, m0, n0);
    }
  }
}

}  // namespace wg
}  // namespace p2v
