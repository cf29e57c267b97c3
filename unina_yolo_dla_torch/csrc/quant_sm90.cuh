// The int8 quantiser's exact division, shared by the kernels that
// quantise or requantise to int8 (int8_conv.cu, qconcat.cu).
//
// The reference quantises with clip(round(v / s), -127, 127): an IEEE
// single-precision division, round half to even, then the clip. The
// kernels compute it from the reciprocal of s rounded to double, taken
// once per launch (`quant_reciprocal`), with one multiply and one
// rounding an element (`requant`).
#pragma once

#include <cuda_runtime.h>

// 1 / s rounded to double: `requant`'s second argument
__device__ __forceinline__ double quant_reciprocal(float s) {
  return __drcp_rn((double)s);
}

// clamp(rint(v / s), -127, 127) with v / s the correctly rounded f32
// quotient, from r = 1 / s rounded to double: the quotient of two f32
// values is never a midpoint of f32 and lies at least 2^-49 (relative)
// from one, and v * r is within 2^-52 of it, so rounding v * r once to
// f32 gives the quotient. (The library's f32 division, __fdiv_rn, cost
// 4-6 us a layer of the int8 conv on an H100; a multiply by an f32
// reciprocal moves int8 steps.)
__device__ __forceinline__ float requant(float v, double r) {
  const float q = __double2float_rn(__dmul_rn((double)v, r));
  return fminf(fmaxf(rintf(q), -127.f), 127.f);
}
