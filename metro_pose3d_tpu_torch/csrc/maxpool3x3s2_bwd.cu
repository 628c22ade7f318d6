// Gradient of the 3x3 stride-2 max pool (the ResNet stem pool) in its three
// alignments: "SAME", torch and Keras (see maxpool3x3s2.cu).
//
// Replaces: the TPU has no Pallas backward. JAX training differentiates the
// shift-and-max chain of metro_pose3d_tpu/ops/pool_pallas.py
// (`stem_max_pool(mode, train=True)` -> `_maxpool_reference[_odd]`,
// `_maxpool_reference_torch`, `_maxpool_reference_keras`), whose forward
// kernel `_maxpool_fwd_pallas` is ported in maxpool3x3s2.cu.
//
// Semantics: the forward is the chain m_0 = v_0, m_j = max(m_{j-1}, v_j)
// over the window's nine taps v_j, j = 3 dy + dx, where a tap outside the
// image has the value `fill` (-inf; 0.0 in the Keras alignment). A pad tap
// is a link of the chain like any other: in the Keras alignment a pad 0
// that wins takes the whole gradient, and one that ties takes half of it;
// that share belongs to no input element and is dropped. After a ReLU the
// input is full of exact zeros, which tie with one another and with the
// Keras pad, so ties are the common case there. The chain's gradient, as
// autograd of torch.maximum (and lax.max) gives it:
// step j sends its incoming gradient to m_{j-1} with weight l_j and to v_j
// with weight r_j, where (l, r) = (1, 0) if m_{j-1} > v_j, (0, 1) if
// m_{j-1} < v_j, and (1/2, 1/2) on a tie (a NaN gives (1, 1), as
// torch.maximum's backward does). Tap k of a window therefore gets
// g * r_k * l_{k+1} * ... * l_8 (r_0 = 1): a power of two, so each product is
// exact, and ties split exactly as the chain splits them.
//
// What bounds it on the card: bytes. Each input element reads its own
// value, the up to four window gradients that contain it, and re-reads the
// nine taps of each of those windows, all neighbours of one another, so the
// re-reads hit L1. At the main-path shape [B,64,128,128] bf16 the HBM floor
// is reading x and g and writing dx: about 2.25x the bytes of x.
//
// Design: one thread per INPUT element (b, iy, ix, c) of a channels-last
// tensor, channels innermost so a warp's loads are coalesced. It gathers
// from the windows that contain it (two rows by two columns at most),
// re-walks each window's chain to find its own weight, sums in float32 in a
// fixed order (window row, then column) and writes once in x's dtype. No
// atomics, so the result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Weight of tap k (0..8) in the gradient of window (oy, ox)'s chain.
template <typename T>
__device__ __forceinline__ float tap_weight(const T* __restrict__ xb, int H, int W, int C,
                                            int y0, int x0, int k, float fill) {
  float m = 0.0f, w = 0.0f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int yy = y0 + j / 3, xx = x0 + j % 3;
    const float v = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                        ? to_float(xb[((int64_t)yy * W + xx) * C])
                        : fill;
    if (j == 0) {
      m = v;
      w = (k == 0) ? 1.0f : 0.0f;
      continue;
    }
    const float l = (m == v) ? 0.5f : ((m < v) ? 0.0f : 1.0f);
    const float r = (m == v) ? 0.5f : ((m > v) ? 0.0f : 1.0f);
    if (j == k) {
      w = r;
    } else if (j > k) {
      w *= l;
    }
    m = (v > m || v != v) ? v : m;  // torch.maximum: NaN propagates
  }
  return w;
}

template <typename T>
__global__ void maxpool3x3s2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                        T* __restrict__ dx, int B, int H, int W, int C, int OH,
                                        int OW, int pad_top, int pad_left, float fill) {
  const int64_t total = (int64_t)B * H * W * C;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  int64_t r = i / C;
  const int ix = (int)(r % W);
  r /= W;
  const int iy = (int)(r % H);
  const int b = (int)(r / H);

  const T* xb = x + (int64_t)b * H * W * C + c;
  const T* gb = g + (int64_t)b * OH * OW * C + c;
  // window (oy, ox) covers rows 2 oy - pad_top + dy, dy in 0..2
  const int ty = iy + pad_top, tx = ix + pad_left;
  float acc = 0.0f;
#pragma unroll
  for (int a = 1; a >= 0; --a) {
    const int oy = ty / 2 - a;
    const int dy = ty - 2 * oy;
    if (oy < 0 || oy >= OH || dy > 2) continue;
#pragma unroll
    for (int e = 1; e >= 0; --e) {
      const int ox = tx / 2 - e;
      const int dxx = tx - 2 * ox;
      if (ox < 0 || ox >= OW || dxx > 2) continue;
      const float w =
          tap_weight(xb, H, W, C, 2 * oy - pad_top, 2 * ox - pad_left, dy * 3 + dxx, fill);
      if (w != 0.0f) acc += to_float(gb[((int64_t)oy * OW + ox) * C]) * w;
    }
  }
  store(dx + i, acc);
}

}  // namespace

// x, g, dx channels-last: x and dx [B, H, W, C], g [B, OH, OW, C].
// dtype: 0 = float32, 1 = bfloat16; fill as in the forward. Returns
// cudaGetLastError() after the launch.
extern "C" int metro_maxpool3x3s2_bwd(const void* x, const void* g, void* dx, int dtype, int B,
                                      int H, int W, int C, int OH, int OW, int pad_top,
                                      int pad_left, float fill, void* stream) {
  const int64_t total = (int64_t)B * H * W * C;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    maxpool3x3s2_bwd_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)g, (float*)dx, B, H, W, C, OH, OW, pad_top, pad_left,
        fill);
  } else if (dtype == 1) {
    maxpool3x3s2_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, B, H, W, C, OH,
        OW, pad_top, pad_left, fill);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
