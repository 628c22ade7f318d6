// The per-element float32 steps of the int8 serving path, shared by QK1's
// epilogues (int8_conv.cu) and QK2's forms (int8_quant.cu), so that the two
// compute the same bits. Each is the JAX package's arithmetic
// (metro_pose3d_tpu/models/quantize.py) in its order: a product, then a sum,
// each rounded (the intrinsics are never contracted into an FMA), a true
// division, round half to even (rintf), clip to +-127. An int32 accumulator
// converts to float32 with round to nearest (__int2float_rn), as
// `acc.astype(float32)` does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8q {

// element types as the Python wrappers number them (ops/int8.py)
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kI8 = 3 };

// clip(round(y), -127, 127), round half to even (NaN gives -127). Clipped
// first, then rounded: for a bound of +-127 the two orders agree for every
// float (checked over all 2^32 inputs). The rounding is the float32 sum
// t + 1.5 * 2^23, whose last bit has the weight 1: half to even, the
// integer read from the bits, without the 16-a-clock conversions (FRND,
// F2I) of rintf and (int).
__device__ __forceinline__ int8_t clip_round(float y) {
  const float t = fminf(fmaxf(y, -127.0f), 127.0f);
  return (int8_t)(__float_as_int(__fadd_rn(t, 12582912.0f)) - 0x4B400000);
}

// acc.astype(float32), exact, for |acc| <= 2^22 (int8 products over K <= 256):
// the float whose bits are those of 1.5 * 2^23 plus acc, less 1.5 * 2^23;
// two full-rate adds in place of a 16-a-clock I2F (checked for every such acc)
__device__ __forceinline__ float small_acc_to_float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
}

// quantize: clip(round(x / sa))
__device__ __forceinline__ int8_t quantize(float x, float sa) { return clip_round(__fdiv_rn(x, sa)); }

// junction / requant from acc as float32: clip(round(relu?(acc * m + b)))
__device__ __forceinline__ int8_t requant_f(float accf, float m, float b, bool relu) {
  float y = __fadd_rn(__fmul_rn(accf, m), b);
  if (relu && y < 0.0f) y = 0.0f;
  return clip_round(y);
}

__device__ __forceinline__ int8_t requant(int acc, float m, float b, bool relu) {
  return requant_f(__int2float_rn(acc), m, b, relu);
}

// dequant: (acc * s).to(T), then + bias.to(T) in T (a bf16 sum is rounded
// from its float32 sum, as PyTorch and XLA add two bf16 values)
template <typename T>
struct Dequant;

template <>
struct Dequant<float> {
  static __device__ __forceinline__ float apply(int acc, float s, const float* bias, int c) {
    const float y = __fmul_rn(__int2float_rn(acc), s);
    return bias ? __fadd_rn(y, bias[c]) : y;
  }
};

template <>
struct Dequant<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 apply(int acc, float s, const float* bias,
                                                        int c) {
    const __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
    if (!bias) return y;
    const float b = __bfloat162float(__float2bfloat16_rn(bias[c]));
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
  }
};

// the bf16 dequant of two neighbouring channels, from acc as float32, in
// apply's steps, each pair rounded by one conversion; b0, b1 are the
// biases already rounded to bf16 (as float32), used when has_bias
__device__ __forceinline__ __nv_bfloat162 dequant_bf16_pair(float acc0, float acc1, float s0,
                                                            float s1, bool has_bias, float b0,
                                                            float b1) {
  const __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(acc0, s0), __fmul_rn(acc1, s1));
  if (!has_bias) return y;
  return __floats2bfloat162_rn(__fadd_rn(__bfloat162float(y.x), b0),
                               __fadd_rn(__bfloat162float(y.y), b1));
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace int8q
