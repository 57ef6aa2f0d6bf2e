// The integer-LN element chain in the form the LN kernels issue it, shared by
// csrc/intln.cu, csrc/embed_fused.cu and csrc/swin_stem.cu: int8 codes to
// floats by a byte permute, the exponent-field powers of the chain, and the
// codes out of it (ln_code_fast), each equal to p2v::ln_elem and the plain
// version's clip(round(·)).to(int8), checked over all 2^32 floats on the
// card (p2v_ln_chain_check in csrc/intln.cu).
#pragma once

#include "matmul_tiles.cuh"

namespace p2v {

constexpr uint32_t kFlip = 0x80808080u;  // int8 byte → byte + 128, per byte

// code of byte e (0..3) of a word already xor-ed with kFlip, as a float:
// the bits 0x4B4000bb are 1.5·2^23 + byte + 128, exact.
__device__ __forceinline__ float code_f(uint32_t flipped, int e) {
  return __fsub_rn(__uint_as_float(__byte_perm(flipped, 0x4B400000u, 0x7650u | e)), 12583040.f);
}

// the low bytes of four words (int8 codes, or biased codes' bits) as one word
__device__ __forceinline__ uint32_t pack4(const uint32_t (&t)[4]) {
  return __byte_perm(__byte_perm(t[0], t[1], 0x0040u), __byte_perm(t[2], t[3], 0x0040u), 0x5410u);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// int8 code of clip(round(v)); a NaN v gives the int8 cast of NaN, as the
// plain version's torch.clamp keeps NaN and .to(int8) casts it
__device__ __forceinline__ uint32_t code_of(float v) {
  return v != v ? static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v)))
                : code_byte(biased(v, -128.f, 127.f));
}

// The exponent-field powers of the LN chain, 2^N and 2^-N with
// N = clip(7 − ⌊log2|a|⌋, 0, 31), from a's bits: (N + 127)·2^23 =
// (261 − e)·2^23 for the biased exponent e, clipped as unsigned to
// [127, 158]·2^23; 2^-N's bits are 254·2^23 minus 2^N's. Equal to
// p2v::exp2i(n), exp2i(-n) of ln_elem for all 2^32 a (p2v_ln_chain_check).
__device__ __forceinline__ uint32_t p2n_bits(float a) {
  return min(max(0x82800000u - (__float_as_uint(a) & 0x7F800000u), 0x3F800000u), 0x4F000000u);
}

// clip(rint(z)) onto the int8 range in one saturating conversion (half to
// even; NaN would give 0, so callers pass no NaN); its low byte is the code
__device__ __forceinline__ uint32_t code_sat(float z) {
  int r;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(r) : "f"(z));
  return static_cast<uint32_t>(r);
}

// p2v::ln_code (ln_elem, then clip(round(y·ratio))) as an int8 byte, with
// the powers from p2n_bits and, where every ratio is 1 (UNIT), round(y)
// folded into one saturating conversion: clip(rint(z)) = clip(rint(rint(z)·1)),
// checked for all 2^32 z but NaN (p2v_ln_chain_check). With finite row
// constants and column vectors (and |m·x| ≤ 255·128·|mask| finite), a is
// not NaN, so M's clip needs no lower bound, and z is never NaN (no sum
// meets two infinities); rint(z)·ratio can be NaN (∞·0), so the general
// form takes code_of.
template <bool UNIT>
__device__ __forceinline__ uint32_t ln_code_fast(const LnRow& row, float x, float w_os, float b_os, float ratio) {
  const float a = __fmul_rn(row.s1_over_std, w_os);
  const uint32_t pb = p2n_bits(a);
  const float p2n = __uint_as_float(pb), p2mn = __uint_as_float(0x7F000000u - pb);
  const float m = fminf(floorf(__fmul_rn(fabsf(a), p2n)), 255.f);  // ≥ 0: a is not NaN
  const float bb = rintf(__fmul_rn(__fsub_rn(b_os, __fmul_rn(row.mean_over_std, w_os)), p2n));
  const float z = __fmul_rn(__fadd_rn(__fmul_rn(copysignf(m, a), x), bb), p2mn);
  return UNIT ? code_sat(z) : code_of(__fmul_rn(rintf(z), ratio));
}

// The LN code of one element where the row constants or a column vector
// are not finite (a row of zero codes: mean/std = 0/0): ln_elem as written,
// its NaN cast as the plain version casts it. Ratio 1.
__device__ __forceinline__ uint32_t ln_code_exact(const LnRow& row, float x, float w_os, float b_os) {
  return code_of(ln_elem(row, x, w_os, b_os));
}

// The exact sums of a lane where every mask is a small integer: Σx in a
// float (exact below 2^24), Σx² as int32 over float chunk sums.
struct FastSums {
  float sx = 0.f, chunk = 0.f;
  int sxx = 0;
  __device__ __forceinline__ void add(float x) {
    sx = __fadd_rn(sx, x);
    chunk = __fmaf_rn(x, x, chunk);
  }
  __device__ __forceinline__ void end_chunk() {
    sxx += __float2int_rn(chunk);
    chunk = 0.f;
  }
};

}  // namespace p2v
