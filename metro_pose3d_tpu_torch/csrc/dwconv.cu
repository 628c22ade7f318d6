// Depthwise 3 x 3 convolution (groups = channels, no bias) over an [N, H, W, C]
// tensor in float32 or bf16 (torch.channels_last memory, the backbone's
// layout), with a stride, a dilation and zero padding given by its top and
// left (the bottom and right follow from the output size):
//   y[n, oh, ow, c] = round_T(sum over a, b of x[n, ih, iw, c] * w[a, b, c]),
//   ih = oh * stride - pad_top + a * dilation, iw likewise, x = 0 outside,
// the taps summed in row-major order (a, then b) from 0.0f in float32, each
// product and each sum rounded (the library is built with -fmad=false), and
// the sum rounded once to T with __float2bfloat16_rn. `w` holds the 9 taps
// tap-major, [9, C], in T. This is the order and the rounding of
// the plain twin (ops/dwconv.py::depthwise_conv_plain), which sums shifted
// float32 slices one tap at a time: on the card the two are equal bit for
// bit, NaN, infinities and the sign of zero included.
//
// Replaces no TPU kernel: the JAX package has no EfficientNetV2 trunk. It
// serves the MBConv blocks of the port's (models/efficientnet.py), whose 61
// depthwise convs a forward cuDNN ran in channels_last bf16 through a
// generic grouped kernel (conv2d_grouped_direct_kernel) at 146 ms for 128
// rows of EfficientNetV2-L at 256^2 on an NVIDIA H100 80GB HBM3 (700 W),
// about 3% of their bytes bound; PyTorch's NCHW depthwise kernel with the two
// layout changes around it took 90 ms there.
//
// What bounds it: bytes, the input read once and the output written once
// (the weights are small): 15.1 GB, 4.51 ms, for those 61 convs. Eighteen
// float32 operations an output element are far below the compute bound.
//
// Design: a thread computes one output pixel's 16-byte vector of channels
// (8 bf16 or 4 float32) and loads the 9 input vectors and weight vectors
// it needs; neighbouring threads take neighbouring channel vectors of a
// pixel, then the next pixel along the row, so each tap's loads of a warp
// are 512 contiguous bytes, and the input vectors that neighbouring pixels
// share come from L1 and L2. The scalar variant (one channel a thread) takes
// C not a multiple of the vector or pointers off 16 bytes. A grid-stride
// loop over as many blocks as the card holds at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int K = 3;  // the kernel side

enum Dtype { kF32 = 0, kBF16 = 1 };

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

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_float(*p);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_float(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* acc) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(acc[0]);
  } else {
    alignas(16) T o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_float<T>(acc[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
}

// `total` = N * OH * OW * (C / VEC) work items, the channel vector fastest
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    dwconv_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       int H, int W, int C, int OH, int OW, int stride, int dil, int pad_top,
                       int pad_left, long long total) {
  const int groups = C / VEC;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += step) {
    const int c0 = (int)(i % groups) * VEC;
    long long p = i / groups;
    const int ow = (int)(p % OW);
    p /= OW;
    const int oh = (int)(p % OH);
    const long long n = p / OH;
    const int ih0 = oh * stride - pad_top, iw0 = ow * stride - pad_left;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const int ih = ih0 + a * dil;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const int iw = iw0 + b * dil;
        float xv[VEC], wv[VEC];
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
          load<T, VEC>(x + ((n * H + ih) * W + iw) * C + c0, xv);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) xv[j] = 0.0f;  // the zero padding, multiplied as the twin does
        }
        load<T, VEC>(w + (long long)(a * K + b) * C + c0, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = acc[j] + xv[j] * wv[j];
      }
    }
    store<T, VEC>(y + ((n * OH + oh) * OW + ow) * C + c0, acc);
  }
}

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

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* w, void* y, int N, int H, int W, int C, int OH,
                   int OW, int stride, int dil, int pad_top, int pad_left, cudaStream_t s) {
  constexpr auto kernel = dwconv_nhwc_kernel<T, VEC>;
  const long long total = (long long)N * OH * OW * (C / VEC);
  kernel<<<(unsigned)grid_size<kernel>(total), kThreads, 0, s>>>(
      (const T*)x, (const T*)w, (T*)y, H, W, C, OH, OW, stride, dil, pad_top, pad_left, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(int vec, const void* x, const void* w, void* y, int N, int H, int W, int C,
                       int OH, int OW, int stride, int dil, int pad_top, int pad_left,
                       cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec == 1)
    return launch<T, 1>(x, w, y, N, H, W, C, OH, OW, stride, dil, pad_top, pad_left, s);
  return launch<T, VEC>(x, w, y, N, H, W, C, OH, OW, stride, dil, pad_top, pad_left, s);
}

}  // namespace

// x: [N, H, W, C], y: [N, OH, OW, C], w: [9, C], all of `dtype` (0 float32,
// 1 bf16) and dense; k must be 3. vec is 1 or the elements of a
// 16-byte vector (4 float32, 8 bf16), which needs C a multiple of it and x,
// w and y 16-byte aligned. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int metro_dwconv(const void* x, const void* w, void* y, int dtype, int vec, int N,
                            int H, int W, int C, int OH, int OW, int k, int stride, int dilation,
                            int pad_top, int pad_left, void* stream) {
  if ((long long)N * OH * OW * C == 0) return (int)cudaSuccess;
  if ((dtype != kF32 && dtype != kBF16) || k != K || N < 0 || H < 1 || W < 1 ||
      C < 1 || OH < 1 || OW < 1 || stride < 1 || dilation < 1 || !x || !w || !y)
    return (int)cudaErrorInvalidValue;
  const int full = dtype == kF32 ? 4 : 8;
  if (vec != 1 && (vec != full || C % vec != 0 ||
                   ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return (int)launch_vec<float>(vec, x, w, y, N, H, W, C, OH, OW, stride, dilation, pad_top,
                                  pad_left, st);
  return (int)launch_vec<__nv_bfloat16>(vec, x, w, y, N, H, W, C, OH, OW, stride, dilation,
                                        pad_top, pad_left, st);
}
