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

__device__ __forceinline__ int8_t clip_round(float y) {
  const float r = fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  return (int8_t)(int)r;
}

// quantize: clip(round(x / sa))
__device__ __forceinline__ int8_t quantize(float x, float sa) { return clip_round(__fdiv_rn(x, sa)); }

// junction / requant: clip(round(relu?(acc * m + b)))
__device__ __forceinline__ int8_t requant(int acc, float m, float b, bool relu) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
  if (relu && y < 0.0f) y = 0.0f;
  return clip_round(y);
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

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace int8q
