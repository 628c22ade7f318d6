// QK2: the elementwise forms of the int8 serving path, over a dense tensor
// whose last memory axis is the channel (NHWC, or [M, C]):
//   quantize  float32 / bf16 -> int8, clip(round(x / sa)), sa one scalar;
//   junction  int32 -> int8, clip(round(relu?(acc * m[c] + b[c])));
//   dequant   int32 -> float32 / bf16, (acc * s[c]).to(T) + bias[c].to(T).
// The arithmetic is int8_epilogue.cuh's, shared with QK1's epilogues.
//
// Not a TPU kernel: in the JAX package XLA fuses these passes into the int8
// convolutions around them (metro_pose3d_tpu/models/quantize.py). Here they
// run where a conv has no kernel of this repository to carry them: a block's
// first conv input (quantize), junction 1 on conv1's `_int_mm` sums, the
// 1 x 1 convs' dequant.
//
// What bounds it on the card: bytes, each input read once and each output
// written once (5 bytes an element for the junction, 3 to 6 for the others);
// a handful of float operations an element are far below any compute bound.
//
// Design: a thread takes 16 consecutive elements with 16-byte loads and
// stores (one uint4 of int8 out, 2 to 4 in), grid-stride, when every pointer
// is 16-byte aligned (vec 16); the channel of element i is i % C, carried
// along the 16. A ragged last chunk, and the scalar variant (vec 1), go one
// element at a time.
#include "int8_epilogue.cuh"

namespace {

using namespace int8q;

enum Form { kQuantize = 0, kJunction = 1, kDequantize = 2 };

constexpr int kThreads = 256;
constexpr int kVec = 16;

template <int FORM, typename InT, typename OutT>
__device__ __forceinline__ OutT one(InT v, const float* scale, const float* bias, int c,
                                    bool relu, float sa) {
  if constexpr (FORM == kQuantize) {
    return quantize(to_float<InT>(v), sa);
  } else if constexpr (FORM == kJunction) {
    return requant(v, scale[c], bias[c], relu);
  } else {
    return Dequant<OutT>::apply(v, scale[c], bias, c);
  }
}

template <int FORM, typename InT, typename OutT, int VEC>
__global__ void __launch_bounds__(kThreads)
    int8_elementwise_kernel(const InT* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ bias, OutT* __restrict__ out,
                            long long n, int C, int relu) {
  const float sa = FORM == kQuantize ? scale[0] : 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (VEC == 1) {
    for (long long i = first; i < n; i += stride)
      out[i] = one<FORM, InT, OutT>(x[i], scale, bias, FORM == kQuantize ? 0 : (int)(i % C),
                                    relu != 0, sa);
  } else {
    const long long chunks = (n + kVec - 1) / kVec;
    for (long long ch = first; ch < chunks; ch += stride) {
      const long long i0 = ch * kVec;
      int c = FORM == kQuantize ? 0 : (int)(i0 % C);
      if (i0 + kVec <= n) {
        alignas(16) InT v[kVec];
        alignas(16) OutT o[kVec];
        const uint4* src = reinterpret_cast<const uint4*>(x + i0);
#pragma unroll
        for (int q = 0; q < (int)(kVec * sizeof(InT) / 16); ++q)
          reinterpret_cast<uint4*>(v)[q] = src[q];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          o[j] = one<FORM, InT, OutT>(v[j], scale, bias, c, relu != 0, sa);
          if (FORM != kQuantize && ++c == C) c = 0;
        }
        uint4* dst = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
        for (int q = 0; q < (int)(kVec * sizeof(OutT) / 16); ++q)
          dst[q] = reinterpret_cast<const uint4*>(o)[q];
      } else {
        for (long long i = i0; i < n; ++i) {
          out[i] = one<FORM, InT, OutT>(x[i], scale, bias, c, relu != 0, sa);
          if (FORM != kQuantize && ++c == C) c = 0;
        }
      }
    }
  }
}

template <int FORM, typename InT, typename OutT>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* out, long long n,
                   int C, int relu, int vec, cudaStream_t s) {
  const long long per_thread = vec == kVec ? kVec : 1;
  long long blocks = (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks an SM
  if (vec == kVec)
    int8_elementwise_kernel<FORM, InT, OutT, kVec><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const InT*)x, scale, bias, (OutT*)out, n, C, relu);
  else
    int8_elementwise_kernel<FORM, InT, OutT, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const InT*)x, scale, bias, (OutT*)out, n, C, relu);
  return cudaGetLastError();
}

}  // namespace

// x: dense, channel last; n elements, C channels; scale: float32 sa [1]
// (quantize) or per channel [C]; bias: float32 [C] (junction: required;
// dequant: optional, may be null). in_dtype / out_dtype as int8_epilogue.cuh
// numbers them: quantize f32|bf16 -> i8, junction i32 -> i8, dequant i32 ->
// f32|bf16. vec 16 needs x and out 16-byte aligned. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a form
// it does not take.
extern "C" int metro_int8_elementwise(const void* x, const void* scale, const void* bias,
                                      void* out, int form, int in_dtype, int out_dtype,
                                      int relu, int vec, long long n, int C, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((vec != 1 && vec != kVec) || C < 1 || !scale) return (int)cudaErrorInvalidValue;
  if (vec == kVec && ((uintptr_t)x | (uintptr_t)out) % 16 != 0) return (int)cudaErrorInvalidValue;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == kQuantize && out_dtype == kI8) {
    if (in_dtype == kF32) return (int)launch<kQuantize, float, int8_t>(x, sc, bi, out, n, C, relu, vec, s);
    if (in_dtype == kBF16)
      return (int)launch<kQuantize, __nv_bfloat16, int8_t>(x, sc, bi, out, n, C, relu, vec, s);
  } else if (form == kJunction && in_dtype == kI32 && out_dtype == kI8 && bi) {
    return (int)launch<kJunction, int, int8_t>(x, sc, bi, out, n, C, relu, vec, s);
  } else if (form == kDequantize && in_dtype == kI32) {
    if (out_dtype == kF32) return (int)launch<kDequantize, int, float>(x, sc, bi, out, n, C, relu, vec, s);
    if (out_dtype == kBF16)
      return (int)launch<kDequantize, int, __nv_bfloat16>(x, sc, bi, out, n, C, relu, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
