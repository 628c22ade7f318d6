// 3x3 stride-2 max pool (the ResNet stem pool) in its three alignments:
// TF/XLA "SAME", torch (symmetric pad 1, -inf) and Keras (symmetric pad 1 of
// explicit zeros).
//
// Replaces: metro_pose3d_tpu/ops/pool_pallas.py::_maxpool_fwd_pallas
// (kernel `_maxpool_kernel`), an H-blocked Pallas kernel with a halo row, and
// the op's other two alignments there (`max_pool_3x3_stride2_torch`,
// `max_pool_3x3_stride2_keras`).
//
// Semantics: output (oy, ox) is the max over input rows 2*oy - pad_top + dy and
// columns 2*ox - pad_left + dx, dy, dx in 0..2; a tap outside the image has the
// value `fill` and takes part in the max like any other.
//   same:  fill -inf; even sizes pad_top = pad_left = 0 (the pad is on the
//          high side only), odd sizes the XLA split lo = total // 2 = 1.
//   torch: fill -inf, pad_top = pad_left = 1: the window sits at 2i-1..2i+1.
//   keras: the torch window with fill 0.0: a border window whose real values
//          are all negative returns 0. Only the pad cells are 0; the
//          reduction itself starts from -inf, so an interior window of
//          negative values keeps its negative max.
//
// What bounds it on the card: bytes. Nine compares per output and no reuse
// worth a shared-memory stage: each input element is read by at most four
// windows, and those reads hit L1/L2. At the main-path shape [64,128,128,64]
// bf16 the pool reads 128 MiB and writes 32 MiB, so its floor is the HBM
// time of ~160 MiB.
//
// Design: one thread per output element (b, oy, ox, c) of a channels-last
// (NHWC in memory) tensor. Channels are innermost, so neighbouring threads
// read neighbouring addresses and every tap is a coalesced row of a warp.
// Max is exact, so the result equals the plain PyTorch version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// bf16 -> float -> bf16 of a value that was bf16 is exact.
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void maxpool3x3s2_kernel(const T* __restrict__ x, T* __restrict__ y, int B, int H,
                                    int W, int C, int OH, int OW, int pad_top, int pad_left,
                                    float fill) {
  const int64_t total = (int64_t)B * OH * OW * C;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  int64_t r = i / C;
  const int ox = (int)(r % OW);
  r /= OW;
  const int oy = (int)(r % OH);
  const int b = (int)(r / OH);

  const T* xb = x + (int64_t)b * H * W * C + c;
  float m = -CUDART_INF_F;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - pad_top + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - pad_left + dx;
      const float v = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                          ? to_float(xb[((int64_t)iy * W + ix) * C])
                          : fill;
      // NaN propagates, as torch.maximum does in the plain version
      m = (v > m || v != v) ? v : m;
    }
  }
  store(y + i, m);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; fill: the value of a tap outside the image
// (-inf, or 0.0 for the Keras alignment). Returns cudaGetLastError() after the
// launch.
extern "C" int metro_maxpool3x3s2(const void* x, void* y, int dtype, int B, int H, int W, int C,
                                  int OH, int OW, int pad_top, int pad_left, float fill,
                                  void* stream) {
  const int64_t total = (int64_t)B * OH * OW * C;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    maxpool3x3s2_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (float*)y, B, H, W, C, OH, OW, pad_top, pad_left, fill);
  } else if (dtype == 1) {
    maxpool3x3s2_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, B, H, W, C, OH, OW, pad_top, pad_left,
        fill);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
