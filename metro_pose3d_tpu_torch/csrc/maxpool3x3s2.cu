// 3x3 stride-2 max pool (the ResNet stem pool) in its three alignments:
// TF/XLA "SAME", torch (symmetric pad 1, -inf) and Keras (symmetric pad 1 of
// explicit zeros).
//
// Replaces: metro_pose3d_tpu/ops/pool_pallas.py::_maxpool_fwd_pallas
// (kernel `_maxpool_kernel` :35, `pallas_call` :90), an H-blocked Pallas
// kernel with a halo row, and the op's other two alignments there
// (`max_pool_3x3_stride2_torch` :155, `max_pool_3x3_stride2_keras` :295).
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
// The running max starts at -inf and takes tap v when v > m or v is NaN, in
// the order dy-major, dx-minor, compared in float: that is torch.maximum's
// chain in the plain version, so the result equals it value for value, NaN
// where it has NaN. (`__hmax2` is not used: its tie and NaN rules differ.)
//
// What bounds it on the card: bytes. At the main-path shape [128,64,128,128]
// bf16 it must read x once (268 MB) and write y once (67 MB): 0.100 ms at
// 3.35 TB/s. Nine compares per output lane are far below any compute bound.
// The first port (one thread per output element and channel, nine scalar
// 2-byte loads, int64 index division) ran at 0.45 ms: bound by load
// instructions, not by bytes.
//
// Design: a thread takes one channel vector (16 bytes: 8 bf16 or 4 float32
// channels) of two outputs side by side along ox, which share their middle
// tap column: 15 vector loads (3 rows x 5 columns) for two outputs, all
// issued before the first compare so they are in flight together. The grid
// is (channel vector x output pair, output row, batch): neighbouring threads
// take neighbouring channel vectors, so a warp's load covers whole 128-byte
// channel rows of C=64 bf16 pixels, and all index math is 32-bit within one
// image. Rows shared by two output rows are re-read from L2 by the next
// block. The scalar variant (V = 1) is the same code for any C.
#include "maxpool3x3s2_vec.cuh"

#include <math_constants.h>

namespace {

using namespace maxpool;

template <typename T, int V>
__global__ void __launch_bounds__(256)
    maxpool3x3s2_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C, int OH,
                        int OW, int pad_top, int pad_left, float fill) {
  using Raw = typename Vec<T, V>::Raw;
  const int cvs = C / V;
  const int pairs = (OW + 1) / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cvs * pairs) return;
  const int cv = t % cvs, ox = 2 * (t / cvs);
  const int oy = blockIdx.y, b = blockIdx.z;
  const T* xb = x + (int64_t)b * H * W * C + cv * V;
  T* yb = y + ((int64_t)b * OH + oy) * OW * C + cv * V;

  // taps: input rows y0..y0+2, columns x0..x0+4 (output ox takes columns
  // 0..2, output ox + 1 columns 2..4)
  const int y0 = 2 * oy - pad_top, x0 = 2 * ox - pad_left;
  const Raw pad = broadcast<T, V>(fill);
  Raw raw[3][5];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = y0 + dy;
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const int ix = x0 + dx;
      raw[dy][dx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                        ? load<T, V>(xb + (iy * W + ix) * C)
                        : pad;
    }
  }
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      m[i] = -CUDART_INF_F;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float v = lane<T>(raw[dy][2 * o + dx], i);
          m[i] = (v > m[i] || v != v) ? v : m[i];  // torch.maximum: NaN propagates
        }
      }
    }
    if (ox + o < OW) store<T, V>(yb + (ox + o) * C, m);
  }
}

template <typename T, int V>
void launch(const void* x, void* y, int B, int H, int W, int C, int OH, int OW, int pad_top,
            int pad_left, float fill, cudaStream_t s) {
  const int threads = 256;
  const int work = C / V * ((OW + 1) / 2);
  const dim3 grid((work + threads - 1) / threads, OH, B);
  maxpool3x3s2_kernel<T, V><<<grid, threads, 0, s>>>((const T*)x, (T*)y, H, W, C, OH, OW,
                                                     pad_top, pad_left, fill);
}

}  // namespace

// x [B, H, W, C] and y [B, OH, OW, C], channels-last. dtype: 0 = float32,
// 1 = bfloat16; vec: channels a thread loads at once, 1 or a 16-byte vector
// (4 float32, 8 bf16; then C % vec == 0 and x, y 16-byte aligned); fill: the
// value of a tap outside the image (-inf, or 0.0 for the Keras alignment).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int metro_maxpool3x3s2(const void* x, void* y, int dtype, int vec, int B, int H,
                                  int W, int C, int OH, int OW, int pad_top, int pad_left,
                                  float fill, void* stream) {
  const void* ptrs[2] = {x, y};
  if (!maxpool::shape_ok(dtype, vec, B, H, W, C, OH, ptrs, 2)) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * OH * OW * C == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    (vec == 1 ? launch<float, 1> : launch<float, 4>)(x, y, B, H, W, C, OH, OW, pad_top,
                                                     pad_left, fill, s);
  } else {
    (vec == 1 ? launch<__nv_bfloat16, 1> : launch<__nv_bfloat16, 8>)(
        x, y, B, H, W, C, OH, OW, pad_top, pad_left, fill, s);
  }
  return (int)cudaGetLastError();
}
