// Batch norm's inference affine and the activation after it (none, ReLU or
// SiLU), in one pass over an [N, C, H, W] tensor in float32 or bf16,
// channels_last (NHWC in memory, the backbone's layout) or NCHW-contiguous:
//   y = round_T((float(x) - mean[c]) * mul[c] + bias[c]),
//   then, with ReLU, y = isnan(y) ? y : max(y, 0) on the rounded value,
//   or, with SiLU, y = round_T(f / (1 + expf(-f))) with f the rounded value.
// The three float32 operations are rounded one by one in this order (the
// library is built with -fmad=false), as PyTorch's sub, mul and add kernels
// round them, the round to bf16 is __float2bfloat16_rn, as PyTorch's cast,
// and the clamp is F.relu's (clamp_min: NaN kept, fmaxf otherwise): the
// output equals the chain `((x.float() - mean) * mul + bias).to(T)`, then
// F.relu, bit for bit. The SiLU is F.silu's CUDA formula on the rounded
// value, in float32 (x / (1 + exp(-x)), expf and an IEEE division, as
// PyTorch builds it without fast math), rounded once to T. `mul` =
// rsqrt(var + eps) * scale is computed by the caller in PyTorch, on [C]
// vectors, and not here.
//
// Replaces no TPU kernel: XLA fuses flax's BatchNorm and the ReLU into the
// ops around them (metro_pose3d_tpu/models/resnet.py), so the JAX package
// has no kernel for them. The port ran them as six PyTorch kernels in
// float32 (cast, sub, mul, add, cast, ReLU), about 40 bytes of device memory
// traffic an element of bf16; this pass moves 4 (8 in float32). The SiLU
// epilogue serves the EfficientNetV2 trunk (models/efficientnet.py): 142 of
// its 217 batch norms a forward take it, the 75 after a block's projecting
// 1x1 conv none.
//
// What bounds it on the card: bytes, each input read once and each output
// written once. The smallest launch of the main path, stage 4's bn1 at
// [128, 512, 16, 16] bf16, moves 33.6 MB (10 us at 3.35 TB/s); the 49 of a
// bf16 R50 v2 forward at 256^2 and 128 crops 5.8 GB (1.74 ms). About ten
// operations an element (a few more with the SiLU's exponential and
// division) are far below any compute bound.
//
// Design: a thread loads and stores 16-byte vectors (8 bf16 or 4 float32
// channels) and neighbouring threads take neighbouring vectors, so a warp
// moves 512 contiguous bytes an access. In channels_last the grid-stride
// loop's stride is a multiple of the vectors a pixel holds (C / 8 in bf16),
// so a thread meets the same 8 channels at every step and holds their 24
// parameters in registers from its first load on; each step issues 4
// vectors' loads before the first is used, and the grid is as many blocks
// as the card holds at once (132 SMs x the kernel's occupancy). NCHW
// (16-byte vectors inside a plane) and the scalar variant (one element a
// step: C or H*W not a multiple of the vector, or pointers not 16-byte
// aligned) take the channel of each step from its index.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread has in flight in channels_last

enum Dtype { kF32 = 0, kBF16 = 1 };
enum Layout { kChannelsLast = 0, kNCHW = 1 };
enum Act { kNone = 0, kRelu = 1, kSilu = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int ACT>
__device__ __forceinline__ T bn_act(T v, float mean, float mul, float bias) {
  const T r = from_float<T>((to_float(v) - mean) * mul + bias);
  if constexpr (ACT == kNone) return r;
  const float f = to_float(r);
  if constexpr (ACT == kRelu)
    return isnan(f) ? r : from_float<T>(fmaxf(f, 0.0f));  // exact: f and 0 are T values
  return from_float<T>(f / (1.0f + expf(-f)));
}

// channels_last with 16-byte vectors: x and y hold n_vec vectors, `groups`
// (C / VEC) a pixel; `stride` is a multiple of `groups`, and threads at or
// past it have no work
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_act_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ mean, const float* __restrict__ mul,
                       const float* __restrict__ bias, long long n_vec, int groups,
                       long long stride) {
  constexpr int VEC = 16 / sizeof(T);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= stride) return;
  const int c0 = (int)(t % groups) * VEC;
  float m[VEC], s[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mean[c0 + j];
    s[j] = mul[c0 + j];
    b[j] = bias[c0 + j];
  }
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4* dst = reinterpret_cast<uint4*>(y);
  for (long long i = t; i < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n_vec) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride < n_vec) {
        const T* e = reinterpret_cast<const T*>(&v[u]);
        alignas(16) T o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = bn_act<T, ACT>(e[j], m[j], s[j], b[j]);
        dst[i + u * stride] = *reinterpret_cast<const uint4*>(o);
      }
    }
  }
}

// every other case, VEC elements a step (all of one channel): NCHW with
// 16-byte vectors (hw % VEC == 0), or one element (VEC 1) in either layout
template <typename T, int ACT, int VEC, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    bn_act_flat_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ mean, const float* __restrict__ mul,
                       const float* __restrict__ bias, long long n, int C, long long hw) {
  const long long steps = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < steps; i += stride) {
    const long long e0 = i * VEC;
    const int c = (int)(LAYOUT == kChannelsLast ? e0 % C : (e0 / hw) % C);
    const float m = mean[c], s = mul[c], b = bias[c];
    if constexpr (VEC == 1) {
      y[e0] = bn_act<T, ACT>(x[e0], m, s, b);
    } else {
      const uint4 v = reinterpret_cast<const uint4*>(x)[i];
      const T* e = reinterpret_cast<const T*>(&v);
      alignas(16) T o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = bn_act<T, ACT>(e[j], m, s, b);
      reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// blocks for `items` threads' work, at most as many as the card holds at once
template <auto Kernel>
long long grid_size(long long items) {
  static int per_sm = 0;  // Kernel's resident blocks an SM, the same on every card
  if (per_sm == 0) {
    int got = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, Kernel, kThreads, 0);
    per_sm = got > 0 ? got : 1;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  return blocks < cap ? blocks : cap;
}

template <auto Kernel, typename T>
void launch_flat(const T* x, T* y, const float* mean, const float* mul, const float* bias,
                 long long n, int C, long long hw, long long steps, cudaStream_t s) {
  Kernel<<<(unsigned)grid_size<Kernel>(steps), kThreads, 0, s>>>(x, y, mean, mul, bias, n, C,
                                                                  hw);
}

template <typename T, int ACT>
cudaError_t launch(const void* x, void* y, const float* mean, const float* mul,
                   const float* bias, int layout, int vec, long long n, int C, long long hw,
                   cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xt = (const T*)x;
  T* yt = (T*)y;
  if (vec == 1 && layout == kChannelsLast) {
    launch_flat<bn_act_flat_kernel<T, ACT, 1, kChannelsLast>>(xt, yt, mean, mul, bias, n, C,
                                                                hw, n, s);
  } else if (vec == 1) {
    launch_flat<bn_act_flat_kernel<T, ACT, 1, kNCHW>>(xt, yt, mean, mul, bias, n, C, hw, n, s);
  } else if (layout == kNCHW) {
    launch_flat<bn_act_flat_kernel<T, ACT, VEC, kNCHW>>(xt, yt, mean, mul, bias, n, C, hw,
                                                          n / VEC, s);
  } else {
    constexpr auto kernel = bn_act_nhwc_kernel<T, ACT>;
    const long long n_vec = n / VEC;
    const int groups = C / VEC;
    long long blocks = grid_size<kernel>(n_vec);
    const long long least = (groups + kThreads - 1) / kThreads;  // a thread for each group
    if (blocks < least) blocks = least;
    const long long stride = blocks * kThreads / groups * groups;
    kernel<<<(unsigned)blocks, kThreads, 0, s>>>(xt, yt, mean, mul, bias, n_vec, groups, stride);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: n = N * C * hw elements of `dtype` (0 float32, 1 bf16), dense in
// `layout` (0 channels_last, 1 NCHW); mean, mul, bias: float32 [C]. vec is 1
// or the elements of a 16-byte vector (4 float32, 8 bf16), which needs x and
// y 16-byte aligned and C (channels_last) or hw (NCHW) a multiple of it.
// act: 0 none, 1 ReLU, 2 SiLU. Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int metro_bn_act(const void* x, void* y, const void* mean, const void* mul,
                            const void* bias, int dtype, int layout, int act, int vec,
                            long long n, int C, long long hw, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((dtype != kF32 && dtype != kBF16) || (layout != kChannelsLast && layout != kNCHW) ||
      act < kNone || act > kSilu || C < 1 || hw < 1 || n % ((long long)C * hw) != 0 ||
      !mean || !mul || !bias)
    return (int)cudaErrorInvalidValue;
  const int full = dtype == kF32 ? 4 : 8;
  if (vec != 1 && vec != full) return (int)cudaErrorInvalidValue;
  if (vec != 1 && (((uintptr_t)x | (uintptr_t)y) % 16 != 0 ||
                   (layout == kChannelsLast ? C % vec : hw % vec) != 0))
    return (int)cudaErrorInvalidValue;
  const float* m = (const float*)mean;
  const float* s = (const float*)mul;
  const float* b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    switch (act) {
      case kNone: return (int)launch<float, kNone>(x, y, m, s, b, layout, vec, n, C, hw, st);
      case kRelu: return (int)launch<float, kRelu>(x, y, m, s, b, layout, vec, n, C, hw, st);
      default: return (int)launch<float, kSilu>(x, y, m, s, b, layout, vec, n, C, hw, st);
    }
  }
  switch (act) {
    case kNone:
      return (int)launch<__nv_bfloat16, kNone>(x, y, m, s, b, layout, vec, n, C, hw, st);
    case kRelu:
      return (int)launch<__nv_bfloat16, kRelu>(x, y, m, s, b, layout, vec, n, C, hw, st);
    default:
      return (int)launch<__nv_bfloat16, kSilu>(x, y, m, s, b, layout, vec, n, C, hw, st);
  }
}
