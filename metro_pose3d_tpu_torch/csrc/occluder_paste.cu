// Occluder paste: affine RGBA sampling of a uint8 occluder bank, alpha-
// composited over float32 crops in the same pass (training augmentation).
//
// Replaces: metro_pose3d_tpu/ops/warp_pallas.py::sample_occluders_twopass
// (kernel `_occluder_kernel`) and the `paste_rgba` that follows it in
// metro_pose3d_tpu/ops/occlusion.py. The TPU kernel packs RGBA into one
// int32 per texel, pads tiles to 128 lanes, samples in two separable passes
// and routes rotations near +-90 degrees through a transposed tile: all of
// it works around Mosaic's gather limits. None of that is carried over. This
// kernel computes the exact direct map of the plain version
// (metro_pose3d_tpu_torch/ops/occlusion.py::occlude_plain).
//
// Per output pixel p = (x, y) of crop b, with the six scalars of affine[b]
// (row-major [2,3], crop pixel -> tile pixel):
//   u = A00 x + A01 y + A02, v = A10 x + A11 y + A12
//   rgba = bilinear sample of tile idx[b] at (u, v), each tap zero outside
//          the tile, texels times (1/255); then rgba *= enabled[b]
//   out = crop * (1 - alpha) + rgb * alpha
// An index outside [0, N) gives a transparent occluder. The expressions
// keep the plain version's order of operations and the build has no FMA
// contraction (-fmad=false), so each product and sum rounds as there.
//
// What bounds it on the card: bytes. Each output pixel reads 12 bytes of
// crop, writes 12, and reads four 4-byte texels that neighbouring threads
// share through L1 (a 96x96 RGBA tile is 36 KiB). At B=96, S=256 that is
// ~144 MiB of crop traffic, a floor of ~0.05 ms at 3.35 TB/s.
//
// Design: one thread per output pixel (b, y, x), all four channels in that
// thread; x is innermost, so a warp reads and writes 384 contiguous bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One RGBA texel scaled to [0, 1], or zero outside the tile. Inside-ness is
// tested on the float tap, which also sends NaN to the zero border.
__device__ __forceinline__ float4 tap(const uint8_t* __restrict__ tile, float xf, float yf,
                                      int T) {
  if (!(xf >= 0.0f && xf < (float)T && yf >= 0.0f && yf < (float)T)) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const uchar4 t = *reinterpret_cast<const uchar4*>(tile + ((int64_t)(int)yf * T + (int)xf) * 4);
  const float inv255 = 1.0f / 255.0f;
  return make_float4((float)t.x * inv255, (float)t.y * inv255, (float)t.z * inv255,
                     (float)t.w * inv255);
}

__global__ void occluder_paste_kernel(const float* __restrict__ crops,
                                      const uint8_t* __restrict__ bank,
                                      const int32_t* __restrict__ idx,
                                      const float* __restrict__ affine,
                                      const float* __restrict__ enabled,
                                      float* __restrict__ out, int B, int N, int T, int S) {
  const int64_t total = (int64_t)B * S * S;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % S);
  const int y = (int)((i / S) % S);
  const int b = (int)(i / ((int64_t)S * S));

  int n = idx[b];
  const bool valid = n >= 0 && n < N;
  const float on = enabled[b] * (valid ? 1.0f : 0.0f);
  if (!valid) n = 0;
  const float* A = affine + (int64_t)b * 6;
  const float px = (float)x, py = (float)y;
  const float u = A[0] * px + A[1] * py + A[2];
  const float v = A[3] * px + A[4] * py + A[5];
  const float x0 = floorf(u), y0 = floorf(v);
  const float ax = u - x0, ay = v - y0;
  const float w00 = (1.0f - ax) * (1.0f - ay);
  const float w01 = ax * (1.0f - ay);
  const float w10 = (1.0f - ax) * ay;
  const float w11 = ax * ay;
  const uint8_t* tile = bank + (int64_t)n * T * T * 4;
  const float4 t00 = tap(tile, x0, y0, T), t01 = tap(tile, x0 + 1.0f, y0, T);
  const float4 t10 = tap(tile, x0, y0 + 1.0f, T), t11 = tap(tile, x0 + 1.0f, y0 + 1.0f, T);
  // summed left to right, as the plain version sums
  const float rgba[4] = {
      (w00 * t00.x + w01 * t01.x + w10 * t10.x + w11 * t11.x) * on,
      (w00 * t00.y + w01 * t01.y + w10 * t10.y + w11 * t11.y) * on,
      (w00 * t00.z + w01 * t01.z + w10 * t10.z + w11 * t11.z) * on,
      (w00 * t00.w + w01 * t01.w + w10 * t10.w + w11 * t11.w) * on};

  const float alpha = rgba[3];
  const float* src = crops + i * 3;
  float* dst = out + i * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c] = src[c] * (1.0f - alpha) + rgba[c] * alpha;
}

}  // namespace

// crops: float32 [B, S, S, 3]; bank: uint8 [N, T, T, 4]; idx: int32 [B];
// affine: float32 [B, 2, 3]; enabled: float32 [B]; out: float32 [B, S, S, 3].
// Returns cudaGetLastError() after the launch.
extern "C" int metro_occluder_paste(const void* crops, const void* bank, const void* idx,
                                    const void* affine, const void* enabled, void* out, int B,
                                    int N, int T, int S, void* stream) {
  const int64_t total = (int64_t)B * S * S;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  occluder_paste_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)crops, (const uint8_t*)bank, (const int32_t*)idx, (const float*)affine,
      (const float*)enabled, (float*)out, B, N, T, S);
  return (int)cudaGetLastError();
}
