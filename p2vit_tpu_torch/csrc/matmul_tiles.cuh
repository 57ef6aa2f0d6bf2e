// The per-element epilogue chains of the int8 matmul kernels: the requant
// chain, the junction's chain, the LN code and the biased-code helpers that
// the Hopper kernels (gemm_wgmma.cuh, matmul_ln.cu, embed_fused.cu,
// layer_fused.cu) share, so that every path runs the same arithmetic and the
// fused layer equals the four-kernel path bit for bit by construction.
#pragma once

#include "common.cuh"

namespace p2v {

// clip(round(acc·r + b)), or with gelu clip(round(GELU(acc·r + b)·out_inv))
__device__ __forceinline__ float requant_epilogue(int acc, float r, float b, float out_inv, bool gelu,
                                                  float lo, float hi) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), r), b);
  if (gelu) y = __fmul_rn(gelu_as(y), out_inv);
  return requant(y, lo, hi);
}

// A code c = requant(y, lo, hi) held "biased", as the float t = clip(y) +
// 1.5·2^23: the add rounds half to even, as rintf, because the sum's last
// place is 1, and rounding commutes with the clip since lo and hi are
// integers of magnitude ≤ 2^22 (the wrappers check). The bits of t are
// 0x4B400000 + c, so their low byte is c's int8 byte (code_byte), and one
// subtraction gives c as a float (unbias): no conversion instruction, where
// the conversion pipe runs 16 results per clock per SM and the float adder
// 128. rint_clip and rint_clipf equal requant's rintf-then-clip for every
// float y, NaN and ±inf included, up to the sign of a zero code; checked
// over all 2^32 floats on the card (p2v_requant_rint_check).
__device__ __forceinline__ float biased(float y, float lo, float hi) {
  return __fadd_rn(clampf(y, lo, hi), 12582912.f);
}
__device__ __forceinline__ float unbias(float t) { return __fsub_rn(t, 12582912.f); }
__device__ __forceinline__ uint32_t code_byte(float t) { return __float_as_uint(t) & 0xFFu; }
__device__ __forceinline__ int rint_clip(float y, float lo, float hi) {
  return __float_as_int(biased(y, lo, hi)) - 0x4B400000;
}
__device__ __forceinline__ float rint_clipf(float y, float lo, float hi) { return unbias(biased(y, lo, hi)); }

// The residual junction of one element (ops/matmul_ln.py): the mid-node
// code clip(round(acc·r + b)), then the residual code
// clip(round((mid·s_mid + res·s_res)·inv_s_out)), biased.
__device__ __forceinline__ float junction_code(int acc, float r, float b, float s_mid, float res, float s_res,
                                               float inv_s_out, float lo, float hi) {
  const float mid = rint_clipf(__fadd_rn(__fmul_rn(__int2float_rn(acc), r), b), lo, hi);
  const float val = __fadd_rn(__fmul_rn(mid, s_mid), __fmul_rn(res, s_res));
  return biased(__fmul_rn(val, inv_s_out), lo, hi);
}

// The LN code of one aligned element x of a row, clip(round(ln_elem·ratio)),
// biased. A NaN (a row of zero codes: mean/std = 0/0) gives the int8 cast of
// NaN, as the plain version's torch.clamp keeps NaN and .to(int8) casts it;
// clampf would take it to lo.
__device__ __forceinline__ float ln_code(const LnRow& row, float x, float w_os, float b_os, float ratio, float lo,
                                         float hi) {
  const float v = __fmul_rn(ln_elem(row, x, w_os, b_os), ratio);
  return v != v ? __fadd_rn(static_cast<float>(static_cast<int8_t>(v)), 12582912.f) : biased(v, lo, hi);
}

// The LN row constants from the exact integer row sums (Σx² in 64 bits:
// exact while |x| < 2^26 at N ≤ 2048), each rounded once to float32 as the
// plain version's row_sums.
__device__ __forceinline__ LnRow ln_row_exact(int sx, long long sxx, float s1, float c) {
  return ln_row(__int2float_rn(sx), __ll2float_rn(sxx), s1, c);
}

}  // namespace p2v
