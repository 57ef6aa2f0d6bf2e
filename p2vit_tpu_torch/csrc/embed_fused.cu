// The serving prologue in one kernel (ops/embed_fused.py).
//
// Replaces the Pallas kernel p2vit_tpu/ops/embed_fused.py:fused_patch_embed.
// Output rows are the B·(NP+1) tokens. Row p = 0 of an image is [CLS] (the
// constant codes cls[c]); row p ≥ 1 is patch p−1:
//   mid1 = clip(round(acc·r1 + b1)); mid2 = clip(round(mid1·r2));
//   xc   = clip(round((mid2·s_embed + pos[p−1]) / s_qact1))
// then h = clip(round(LN(xc·mask))) with the block-0 LN1 constants.
//
// A block owns BM token rows at full width C: 32, or 16 where the 32 rows'
// int32 row buffer (32·C·4 bytes) would not fit shared memory beside the
// Gemm's stages (C > 1616; the 16-row block takes C ≤ 3272, every width the
// JAX kernel's VMEM guard admits at the zoo's 197 tokens). The Gemm's row
// loader gathers each token's patch from the (B·NP, K) patch matrix (CLS
// rows load zeros), so no [cls; patches] tensor is built. Σx and Σx² are
// exact int32 warp sums. The LN counts the true width c_true: the wrapper
// zero-pads C to a multiple of 8 (and K to a multiple of 16), and zero mask
// and LN vectors past c_true keep those columns out of the sums. Bound: the
// K = 768 int8 matmul.
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use

// the block's Gemm: 32 rows on a 2 × 4 warp grid, 16 rows on 1 × 8
template <int BM>
using Block = p2v::Gemm<BM, 128, BM / 16, 8 / (BM / 16)>;

template <int BM>
constexpr int block_smem(int C) { return Block<BM>::SMEM_BYTES + BM * C * 4; }

// vecs rows: r1, b1, s_qact1, mask, w_os, b_os (each C); scal: r2, s_embed, s1
template <int BM>
__global__ void __launch_bounds__(p2v::kThreads)
    fused_patch_embed_kernel(const int8_t* __restrict__ patches, const int8_t* __restrict__ w,
                             const float* __restrict__ vecs, const float* __restrict__ scal,
                             const float* __restrict__ pos, const int8_t* __restrict__ cls,
                             int8_t* __restrict__ xc_out, int8_t* __restrict__ h_out, int B,
                             int NP, int K, int C, int c_true) {
  using G = Block<BM>;
  extern __shared__ __align__(16) int8_t dsmem[];
  int* rowbuf = reinterpret_cast<int*>(dsmem + G::SMEM_BYTES);  // [BM][C]
  const int ntok = NP + 1, R = B * ntok, m0 = blockIdx.x * BM;
  auto a_row = [&](int rr) -> const int8_t* {
    const int t = m0 + rr;
    if (t >= R) return nullptr;
    const int p = t % ntok;
    return p == 0 ? nullptr : patches + ((size_t)(t / ntok) * NP + (p - 1)) * K;
  };
  for (int n0 = 0; n0 < C; n0 += 128) {
    int acc[G::MT][G::NT][4];
    G::run(a_row,
           [&](int rr) -> const int8_t* { return n0 + rr < C ? w + (size_t)(n0 + rr) * K : nullptr; },
           K, dsmem, acc);
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + G::col_of(j, e);
        if (c < C) rowbuf[G::row_of(0, e) * C + c] = acc[0][j][e];
      }
  }
  __syncthreads();

  const float *r1 = vecs, *b1 = vecs + C, *sq1 = vecs + 2 * C, *mask = vecs + 3 * C,
              *w_os = vecs + 4 * C, *b_os = vecs + 5 * C;
  const float r2 = scal[0], s_embed = scal[1], s1 = scal[2], cf = static_cast<float>(c_true);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < BM; rr += p2v::kThreads / 32) {
    const int t = m0 + rr;
    if (t >= R) break;
    const int p = t % ntok;
    int* row = rowbuf + rr * C;
    const size_t base = (size_t)t * C;
    int sx = 0, sxx = 0;
    for (int c = lane; c < C; c += 32) {
      float code;
      if (p == 0) {
        code = static_cast<float>(cls[c]);
      } else {
        const float mid1 =
            p2v::requant(__fadd_rn(__fmul_rn(__int2float_rn(row[c]), r1[c]), b1[c]), -128.f, 127.f);
        const float mid2 = p2v::requant(__fmul_rn(mid1, r2), -128.f, 127.f);
        const float val = __fadd_rn(__fmul_rn(mid2, s_embed), pos[(size_t)(p - 1) * C + c]);
        code = p2v::requant(__fdiv_rn(val, sq1[c]), -128.f, 127.f);
      }
      xc_out[base + c] = p2v::to_i8(code);
      const int xi = static_cast<int>(__fmul_rn(code, mask[c]));
      row[c] = xi;
      sx += xi;
      sxx += xi * xi;
    }
    sx = p2v::warp_sum(sx);
    sxx = p2v::warp_sum(sxx);
    const p2v::LnRow lr = p2v::ln_row(__int2float_rn(sx), __int2float_rn(sxx), s1, cf);
    for (int c = lane; c < C; c += 32) {
      const float y = p2v::ln_elem(lr, static_cast<float>(row[c]), w_os[c], b_os[c]);
      h_out[base + c] = p2v::to_i8(p2v::requant(y, -128.f, 127.f));
    }
  }
}

template <int BM>
int launch_embed(const void* patches, const void* w, const void* vecs, const void* scal, const void* pos,
                 const void* cls, void* xc_out, void* h_out, int B, int NP, int K, int C, int c_true,
                 cudaStream_t stream) {
  const int smem = block_smem<BM>(C);
  cudaError_t err = p2v::set_smem(fused_patch_embed_kernel<BM>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * (NP + 1);
  fused_patch_embed_kernel<BM><<<(rows + BM - 1) / BM, p2v::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(patches), static_cast<const int8_t*>(w), static_cast<const float*>(vecs),
      static_cast<const float*>(scal), static_cast<const float*>(pos), static_cast<const int8_t*>(cls),
      static_cast<int8_t*>(xc_out), static_cast<int8_t*>(h_out), B, NP, K, C, c_true);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A block of 32 token rows where its row buffer fits, else of 16 (ops/embed_fused.embed_block)
extern "C" int p2v_fused_patch_embed(const void* patches, const void* w, const void* vecs,
                                     const void* scal, const void* pos, const void* cls,
                                     void* xc_out, void* h_out, int B, int NP, int K, int C,
                                     int c_true, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (block_smem<32>(C) <= kMaxSmem)
    return launch_embed<32>(patches, w, vecs, scal, pos, cls, xc_out, h_out, B, NP, K, C, c_true, s);
  if (block_smem<16>(C) <= kMaxSmem)
    return launch_embed<16>(patches, w, vecs, scal, pos, cls, xc_out, h_out, B, NP, K, C, c_true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
