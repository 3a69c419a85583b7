// Double-double arithmetic for fft_dd.cu, built for sm_90a.
//
// A value is an unevaluated sum hi + lo of two floats with |lo| <=
// ulp(hi)/2; a complex value is four floats (re.hi, re.lo, im.hi, im.lo),
// the quad planes of vkfft_tpu_torch/precision/doubledouble.py.  The sums
// and products are error-free transformations (EFTs): each one's rounding
// error is computed exactly and carried in lo, which gives about 2^-48
// relative precision from fp32 arithmetic.
//
// Why the intrinsics.  nvcc contracts a*b + c into one fma by default
// (--fmad=true, which this source's build keeps), and an EFT built from
// plain operators is then silently wrong: Dekker's split t = 4097*a; u = t
// - a becomes u = fma(4097, a, -a) and loses the error term, and a product
// p = a*b fused into a later p + e no longer matches the rounded p the
// error was computed for.  The dd error then degrades from ~1e-14 to ~3e-8
// and nothing raises (recorded in the JAX package's doubledouble.py).
// __fadd_rn, __fsub_rn and __fmul_rn are IEEE operations that nvcc never
// contracts into an fma and never re-associates, so every rounding below
// happens where it is written.  two_prod uses the fma on purpose: p =
// __fmul_rn(a, b) is the rounded product and __fmaf_rn(a, b, -p) its exact
// error (one rounding of an exactly representable value), which replaces
// Dekker's split.  Do not build this source with --use_fast_math or
// -ftz=true: both change these roundings.
//
// Cost, in fp32 operations as written here (an fma counted as 2): add 11
// (two_sum 6, two adds, quick_two_sum 3), mul 10 (a product, three fmas,
// quick_two_sum 3).  `kDdOpFlops` (11) is the count chip_smoke.py's bound
// uses for one dd operation.
#pragma once

#include <cuda_runtime.h>

namespace vkdd {

constexpr int kDdOpFlops = 11;

struct dd {
  float hi, lo;
};

struct ddc {
  dd re, im;
};

// s + e == a + b exactly (Knuth, branch-free).
__device__ __forceinline__ dd two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

// two_sum for |a| >= |b|.
__device__ __forceinline__ dd quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ dd add(dd x, dd y) {
  const dd s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, __fadd_rn(__fadd_rn(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ dd neg(dd x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ dd sub(dd x, dd y) { return add(x, neg(y)); }

// p + e == x.hi * y.hi exactly, then the cross terms into e (their own
// roundings are below the dd precision).
__device__ __forceinline__ dd mul(dd x, dd y) {
  const float p = __fmul_rn(x.hi, y.hi);
  float e = __fmaf_rn(x.hi, y.hi, -p);
  e = __fmaf_rn(x.hi, y.lo, e);
  e = __fmaf_rn(x.lo, y.hi, e);
  return quick_two_sum(p, e);
}

__device__ __forceinline__ ddc cadd(ddc a, ddc b) {
  return {add(a.re, b.re), add(a.im, b.im)};
}
__device__ __forceinline__ ddc csub(ddc a, ddc b) {
  return {sub(a.re, b.re), sub(a.im, b.im)};
}
__device__ __forceinline__ ddc cmul(ddc a, ddc b) {
  return {sub(mul(a.re, b.re), mul(a.im, b.im)),
          add(mul(a.re, b.im), mul(a.im, b.re))};
}
// a times a real dd value.
__device__ __forceinline__ ddc rmul(ddc a, dd c) {
  return {mul(a.re, c), mul(a.im, c)};
}
// a * (-i) for the forward transform, a * (+i) for the inverse: exact.
__device__ __forceinline__ ddc rot(ddc a, int inverse) {
  return inverse ? ddc{neg(a.im), a.re} : ddc{a.im, neg(a.re)};
}

__device__ __forceinline__ ddc from4(float4 v) {
  return {{v.x, v.y}, {v.z, v.w}};
}
__device__ __forceinline__ float4 to4(ddc a) {
  return make_float4(a.re.hi, a.re.lo, a.im.hi, a.im.lo);
}

}  // namespace vkdd
