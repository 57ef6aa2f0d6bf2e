// One quantized ViT encoder layer in one launch (ops/layer_fused.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/layer_fused.py:fused_vit_layer
// (_kernel): qkv GEMM → requant → per-head attention (LIS, or the LIS-off
// fp32 softmax) → proj + residual + LN2 → fc1 + GELU → fc2 + residual + the
// next LN, from (B, N, C) h/xc codes to h'/xc' codes.
//
// The TPU kernel keeps the ~1.8 MB of DeiT-S weight panels resident in VMEM;
// an H100 block has 227 KB of shared memory, so this kernel streams the
// weights from L2 instead and runs the layer as three phases of one
// cooperative launch (a persistent grid, one block of 256 threads per SM at
// DeiT-S, grid.sync() between phases):
//
//   A. the qkv GEMM, M × 3C codes into a workspace: 128×128 tiles, grid-stride
//      (p2v::matmul_requant_tile, the body of csrc/matmul_int8.cu);
//   B. attention, one (image, head) item at a time over the workspace's
//      (B, N, 3C) codes into a second workspace (p2v::vit_attn::attention_item,
//      the body of csrc/attention_lis.cu's attention_rows_kernel);
//   C. everything else is row-local, so one 32-row tile runs it with only
//      __syncthreads(): the proj GEMM into an int32 row buffer, the junction
//      and LN2 (p2v::res_ln_rows, on the per-element chains of csrc/matmul_ln.cu) into the
//      res1 and MLP-input tiles in shared memory; fc1 in 128-column chunks
//      on the resident MLP input, GELU-requantized into a (32, hid) int8 tile
//      in shared memory; fc2 on that resident tile, the junction against
//      res1, then the next LN into ho / xo.
//
// Each phase calls the standalone kernels' own per-tile bodies or per-element
// chains (the row sums are exact integers in any order), so the layer
// equals the four-kernel path (int8_matmul_requant → lis_attention_fused →
// int8_matmul_res_ln → int8_matmul_requant(gelu) → int8_matmul_res_ln) bit
// for bit by construction, on both softmax arms.
//
// Shared memory, the largest phase: C's 25,600 B of GEMM stages + 32·C·4
// (row buffer) + 32·C (res1) + 32·(C+16) (MLP input) + 32·(hid+16) (GELU
// tile): 149,504 B at DeiT-S. Bound on the card: the int8 products (~0.025 ms
// per DeiT-S batch-64 layer); the design pays for simplicity with 8 warps
// per SM in every phase and a weight re-read from L2 per 32-row tile.
#include <cooperative_groups.h>

#include "attention_rows.cuh"
#include "matmul_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using p2v::kLnRows;
constexpr int kPad = 16;  // bytes of padding per resident row (bank spread)

// scal: rq, s_attn, ro, x0_int, b_int, c_int (the attention's, in
// attend_rows' order), fc1_out_inv, s1_ln2, s1_lnn.
// qv (2, 3C), f1v (2, hid): requant and bias; pv, f2v (9, C): the junction
// vectors of res_ln_rows. ws: (M, 3C) qkv codes then (M, C) attention codes,
// written and read inside the launch (no __restrict__ on it). stamps, if
// not null: block 0's %globaltimer (ns) at the start and after each phase.
template <bool LIS>
__global__ void __launch_bounds__(p2v::kThreads, 1)
    fused_vit_layer_kernel(const int8_t* __restrict__ h, const int8_t* __restrict__ xc,
                           const int8_t* __restrict__ wqkv, const float* __restrict__ qv,
                           const int8_t* __restrict__ wproj, const float* __restrict__ pv,
                           const int8_t* __restrict__ wfc1, const float* __restrict__ f1v,
                           const int8_t* __restrict__ wfc2, const float* __restrict__ f2v,
                           const float* __restrict__ scal, int8_t* ws, int8_t* __restrict__ ho,
                           int8_t* __restrict__ xo, unsigned long long* stamps, int B, int N, int C,
                           int H, int hid) {
  extern __shared__ __align__(16) int8_t dsmem[];
  cg::grid_group grid = cg::this_grid();
  auto stamp = [&](int i) {
    if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(stamps[i]));
  };
  stamp(0);
  const int M = B * N, C3 = 3 * C;
  int8_t* qkv = ws;
  int8_t* attn = ws + (size_t)M * C3;

  // ---- A: qkv GEMM → qact1 codes
  const int tiles_n = (C3 + 127) / 128, tiles_a = ((M + 127) / 128) * tiles_n;
  for (int t = blockIdx.x; t < tiles_a; t += gridDim.x)
    p2v::matmul_requant_tile(h, wqkv, qv, qv + C3, 1.f, qkv, M, C3, C, -128.f, 127.f, false,
                             (t / tiles_n) * 128, (t % tiles_n) * 128, dsmem);
  grid.sync();
  stamp(1);

  // ---- B: attention per (image, head) → qact2 codes
  for (int item = blockIdx.x; item < B * H; item += gridDim.x) {
    p2v::vit_attn::attention_item<LIS>(qkv, qkv + C, qkv + 2 * C, C3, (size_t)N * C3, scal, attn, C,
                                       (size_t)N * C, N, H, item, dsmem);
    __syncthreads();  // the next item's copy overwrites the rows
  }
  grid.sync();
  stamp(2);

  // ---- C: per 32-row tile, proj + LN2, fc1 + GELU, fc2 + next LN
  int8_t* stages = dsmem;
  int* rowbuf = reinterpret_cast<int*>(dsmem + p2v::LnGemm::SMEM_BYTES);  // [32][C]
  int8_t* res1 = reinterpret_cast<int8_t*>(rowbuf + kLnRows * C);         // [32][C]
  int8_t* mlp = res1 + kLnRows * C;                                       // [32][C + kPad]
  int8_t* h1 = mlp + kLnRows * (C + kPad);                                // [32][hid + kPad]
  const int mlp_ld = C + kPad, h1_ld = hid + kPad;
  const float fc1_inv = scal[6], s1_ln2 = scal[7], s1_lnn = scal[8];
  const float *f1r = f1v, *f1b = f1v + hid;
  auto none = [](int) -> const int8_t* { return nullptr; };
  using G = p2v::LnGemm;
  for (int t = blockIdx.x; t < (M + kLnRows - 1) / kLnRows; t += gridDim.x) {
    const int m0 = t * kLnRows, rows = min(kLnRows, M - m0);
    const size_t base = (size_t)m0 * C;
    // proj → junction with xc → res1 codes; LN2 → MLP input codes
    p2v::gemm_rows<false>(
        [&](int rr) -> const int8_t* { return m0 + rr < M ? attn + (size_t)(m0 + rr) * C : nullptr; },
        nullptr, 0, wproj, C, C, rowbuf, stages);
    __syncthreads();
    p2v::res_ln_rows(rowbuf, C, rows, xc + base, C, pv, s1_ln2, res1, C, mlp, mlp_ld, -128.f, 127.f);
    __syncthreads();
    // fc1 + GELU → the (32, hid) tile
    for (int n0 = 0; n0 < hid; n0 += 128) {
      int acc[G::MT][G::NT][4];
      G::run_resident(
          mlp, mlp_ld,
          [&](int rr) -> const int8_t* { return n0 + rr < hid ? wfc1 + (size_t)(n0 + rr) * C : nullptr; },
          C, stages, acc);
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + G::col_of(j, e);
          if (n < hid)
            h1[G::row_of(0, e) * h1_ld + n] =
                p2v::to_i8(p2v::requant_epilogue(acc[0][j][e], f1r[n], f1b[n], fc1_inv, true, -128.f, 127.f));
        }
    }
    __syncthreads();
    // fc2 → junction with res1 → xo; the next LN → ho
    p2v::gemm_rows<true>(none, h1, h1_ld, wfc2, C, hid, rowbuf, stages);
    __syncthreads();
    p2v::res_ln_rows(rowbuf, C, rows, res1, C, f2v, s1_lnn, xo + base, C, ho + base, C, -128.f, 127.f);
    __syncthreads();  // the next tile overwrites the row buffer and res1
  }
  if (stamps != nullptr) {
    grid.sync();
    stamp(3);
  }
}

template <bool LIS>
int launch(const void* h, const void* xc, const void* wqkv, const void* qv, const void* wproj,
           const void* pv, const void* wfc1, const void* f1v, const void* wfc2, const void* f2v,
           const void* scal, void* ws, void* ho, void* xo, void* stamps, int B, int N, int C, int H,
           int hid, cudaStream_t stream) {
  auto kernel = fused_vit_layer_kernel<LIS>;
  const int phase_c = p2v::LnGemm::SMEM_BYTES + kLnRows * C * 4 + kLnRows * C + kLnRows * (C + kPad) +
                      kLnRows * (hid + kPad);
  const int smem = max(max(p2v::RequantGemm::SMEM_BYTES, 3 * N * p2v::vit_attn::QROW), phase_c);
  cudaError_t err = p2v::set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p2v::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // no more blocks than the largest phase has work items
  const int M = B * N;
  const int work = max(max(((M + 127) / 128) * ((3 * C + 127) / 128), B * H), (M + kLnRows - 1) / kLnRows);
  const int grid = min(per_sm * sms, work);
  auto* hp = static_cast<const int8_t*>(h);
  auto* xcp = static_cast<const int8_t*>(xc);
  auto* wqkvp = static_cast<const int8_t*>(wqkv);
  auto* qvp = static_cast<const float*>(qv);
  auto* wprojp = static_cast<const int8_t*>(wproj);
  auto* pvp = static_cast<const float*>(pv);
  auto* wfc1p = static_cast<const int8_t*>(wfc1);
  auto* f1vp = static_cast<const float*>(f1v);
  auto* wfc2p = static_cast<const int8_t*>(wfc2);
  auto* f2vp = static_cast<const float*>(f2v);
  auto* scalp = static_cast<const float*>(scal);
  auto* wsp = static_cast<int8_t*>(ws);
  auto* hop = static_cast<int8_t*>(ho);
  auto* xop = static_cast<int8_t*>(xo);
  auto* stampsp = static_cast<unsigned long long*>(stamps);
  void* args[] = {&hp, &xcp, &wqkvp, &qvp, &wprojp, &pvp, &wfc1p, &f1vp, &wfc2p, &f2vp, &scalp,
                  &wsp, &hop, &xop, &stampsp, &B, &N, &C, &H, &hid};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(p2v::kThreads),
                                    args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (B, N, C) h / xc codes -> (B, N, C) ho / xo codes; ws holds B·N·4C bytes;
// stamps: null, or 4 uint64 for the phase timestamps.
extern "C" int p2v_fused_vit_layer(const void* h, const void* xc, const void* wqkv, const void* qv,
                                   const void* wproj, const void* pv, const void* wfc1, const void* f1v,
                                   const void* wfc2, const void* f2v, const void* scal, void* ws,
                                   void* ho, void* xo, void* stamps, int B, int N, int C, int H, int hid,
                                   int lis, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return lis ? launch<true>(h, xc, wqkv, qv, wproj, pv, wfc1, f1v, wfc2, f2v, scal, ws, ho, xo, stamps, B, N,
                            C, H, hid, s)
             : launch<false>(h, xc, wqkv, qv, wproj, pv, wfc1, f1v, wfc2, f2v, scal, ws, ho, xo, stamps, B,
                             N, C, H, hid, s);
}
