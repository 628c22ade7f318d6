// Crop warp: homography + OpenCV lens distortion + bilinear sampling of a
// uint8 RGB source tile, one output crop per batch row, with the input
// normalization fused into the store.
//
// Replaces: metro_pose3d_tpu/ops/warp_pallas.py::warp_images_twopass_pallas
// (kernels `_warp_kernel` and `_warp_kernel_skip`). The TPU kernel splits the
// warp into two separable passes, rounds to uint8 between them, reroutes
// near-90-degree rotations through a transposed source and solves row
// crossings with Newton steps: all of it works around Mosaic's gather limits.
// None of that is carried over. This kernel computes the exact direct map of
// metro_pose3d_tpu/ops/warp.py (`warp_coords` + `bilinear_sample`).
//
// Per output pixel p = (x, y, 1) of crop b, with the 18 scalars of params[b]
// (H row-major, fx fy cx cy, k1 k2 p1 p2 k3):
//   ray = H p; in_front = ray.z > 1e-9; (xn, yn) = ray.xy / ray.z
//   (xd, yd) = OpenCV distortion of (xn, yn); (u, v) = (fx xd + cx, fy yd + cy)
//   v255 = bilinear sample of tile src_idx[b] at (u, v), zero outside the
//          tile, and zero where the ray is not in front of the camera.
// The expressions keep the reference's order of operations. It is compiled
// without fast math and without FMA contraction (-fmad=false), with IEEE
// division, so each product and sum rounds as in the plain PyTorch version:
// near the horizon a lens distortion folds far-away rays back into the tile,
// and there the last ulp of a coordinate moves the sample by many pixels.
//
// Epilogue, applied to v255 before the store (each step rounded in float32,
// as the unfused PyTorch chain rounds it; the constants come from the caller
// as float32, as PyTorch rounds its Python scalars):
//   none       v255                                    float32 [0,255]
//   unit       v255 * unit                             float32 [0,1]
//   normalize  (v255 * unit) * scale + offset          float32 or bf16 [-1,1]
//   normalize_div (v255 / 255) * scale + offset        float32 or bf16 [-1,1]
// normalize_div is the frame path's `normalize(x / 255.0)`: an IEEE division
// (__fdiv_rn), not the product by the rounded reciprocal that `unit` takes.
// bf16 rounds to nearest even with __float2bfloat16_rn, the conversion
// PyTorch's `.to(torch.bfloat16)` runs on the card.
//
// What bounds it on the card: the tile reads and the per-pixel float math
// together, not the bytes alone. At B=64, 512^2 tiles to 256^2 crops, the
// tiles are 50.3 MB and a float32 output 50.3 MB (bf16: 25.2 MB), 0.030 ms
// at 3.35 TB/s; the kernel takes about 0.053 ms in every form, the bf16 one
// (a quarter fewer bytes) included. Each pixel reads twelve bytes scattered
// over two source rows (neighbouring pixels share them through L1), and does
// two IEEE divides and ~100 float operations without FMA (PERF.md).
//
// Design: grid (row segment, group of kWarps rows, crop), 32-bit index
// arithmetic; the block loads its crop's 18 parameters and source index into
// shared memory once. A warp takes 32 * kPix consecutive pixels of one row
// (kPix 4 for float32, 8 for bf16): lane l computes pixels l, l + 32, ..., so
// each load instruction samples 32 neighbouring pixels. Each tap's inside test
// and address serve its three channels, read through the read-only path; a
// byte becomes a float by 2^23 arithmetic (no I2F). The warp stages its
// outputs in shared memory and stores them as 16-byte vectors, consecutive
// lanes on consecutive addresses, where the segment is 16-byte aligned (S a
// multiple of 8), else element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// epilogues, as the wrapper numbers them
constexpr int kNone = 0, kUnit = 1, kNormalize = 2, kNormalizeDiv = 3;
constexpr int kWarps = 4, kThreads = 32 * kWarps;      // a block: one row a warp

struct Epilogue {
  float unit, scale, offset;
};

// a byte as float: 2^23 + b is exact, and so is the subtraction (no I2F)
__device__ __forceinline__ float byte_to_float(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

struct Tap {
  float c[3];
};

// the tap's three channels, or zeros outside the tile; the load always reads
// inside the tile (offset 0 for an outside tap), so no branch is needed
__device__ __forceinline__ Tap load_tap(const uint8_t* __restrict__ img, bool inside, int off) {
  const uint8_t* q = img + (inside ? off : 0);
  Tap t;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) t.c[ch] = inside ? byte_to_float(__ldg(q + ch)) : 0.0f;
  return t;
}

// v255 of output pixel (x, y) into o[0..2]; P: the crop's 18 parameters.
__device__ __forceinline__ void sample(const float* P, const uint8_t* __restrict__ img,
                                       int TH, int TW, int x, int y, float* o) {
  o[0] = o[1] = o[2] = 0.0f;
  const float px = (float)x, py = (float)y;
  const float rx = P[0] * px + P[1] * py + P[2];
  const float ry = P[3] * px + P[4] * py + P[5];
  const float rz = P[6] * px + P[7] * py + P[8];
  const bool in_front = rz > 1e-9f;
  if (!in_front) return;
  const float xn = rx / rz, yn = ry / rz;
  const float fx = P[9], fy = P[10], cx = P[11], cy = P[12];
  const float k1 = P[13], k2 = P[14], p1 = P[15], p2 = P[16], k3 = P[17];
  const float r2 = xn * xn + yn * yn;
  const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
  const float xd = xn * radial + 2.0f * p1 * xn * yn + p2 * (r2 + 2.0f * xn * xn);
  const float yd = yn * radial + p1 * (r2 + 2.0f * yn * yn) + 2.0f * p2 * xn * yn;
  const float u = xd * fx + cx;
  const float v = yd * fy + cy;

  const float x0 = floorf(u), y0 = floorf(v);
  const float ax = u - x0, ay = v - y0;
  const float w00 = (1.0f - ax) * (1.0f - ay);
  const float w01 = ax * (1.0f - ay);
  const float w10 = (1.0f - ax) * ay;
  const float w11 = ax * ay;
  // the reference tests inside-ness on the integer tap; for |x| < 2^24 this is
  // the same test on the float, which also sends NaN to the zero border
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const bool ix0 = x0 >= 0.0f && x0 < (float)TW, ix1 = x1 >= 0.0f && x1 < (float)TW;
  const bool iy0 = y0 >= 0.0f && y0 < (float)TH, iy1 = y1 >= 0.0f && y1 < (float)TH;
  // inside a tap, its integer coordinates are exact; outside they are not used
  const int xi = ix0 ? (int)x0 : (int)x1 - 1, yi = iy0 ? (int)y0 : (int)y1 - 1;
  const int off00 = (yi * TW + xi) * 3;
  const Tap t00 = load_tap(img, iy0 && ix0, off00);
  const Tap t01 = load_tap(img, iy0 && ix1, off00 + 3);
  const Tap t10 = load_tap(img, iy1 && ix0, off00 + 3 * TW);
  const Tap t11 = load_tap(img, iy1 && ix1, off00 + 3 * TW + 3);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    o[ch] = w00 * t00.c[ch] + w01 * t01.c[ch] + w10 * t10.c[ch] + w11 * t11.c[ch];
}

template <int kEpi>
__device__ __forceinline__ float epilogue(float v, const Epilogue& e) {
  if (kEpi == kNone) return v;
  const float t = kEpi == kNormalizeDiv ? __fdiv_rn(v, 255.0f) : __fmul_rn(v, e.unit);
  if (kEpi == kUnit) return t;
  return __fadd_rn(__fmul_rn(t, e.scale), e.offset);
}

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// a warp takes 32 * kPix consecutive pixels of one row; lane l computes pixels
// l, l + 32, ... of them, so each load instruction of the warp samples 32
// neighbouring pixels
template <int kEpi, typename OutT, int kPix>
__global__ void __launch_bounds__(kThreads)
    warp_crop_kernel(const uint8_t* __restrict__ src, const float* __restrict__ params,
                     const int32_t* __restrict__ src_idx, OutT* __restrict__ out, int N, int TH,
                     int TW, int S, Epilogue epi) {
  constexpr int kSeg = 32 * kPix;  // pixels a warp
  __shared__ float sP[18];
  __shared__ int sN;
  __shared__ __align__(16) OutT stage[kWarps][kSeg * 3];  // 1536 bytes a warp
  const int b = blockIdx.z;
  const int t = threadIdx.y * 32 + threadIdx.x;
  if (t < 18) sP[t] = __ldg(params + b * 18 + t);
  if (t == 18) sN = __ldg(src_idx + b);
  __syncthreads();
  const int y = blockIdx.y * kWarps + threadIdx.y;  // the warp's row
  if (y >= S) return;
  const int lane = threadIdx.x;
  const int seg = blockIdx.x * kSeg;  // the warp's first pixel in its row
  const int npix = min(kSeg, S - seg);
  float P[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) P[i] = sP[i];
  const int n = sN;
  // out of range: a zero crop before the epilogue (the wrapper does not sync to check)
  const bool have = n >= 0 && n < N;
  const uint8_t* img = src + (int64_t)(have ? n : 0) * TH * TW * 3;

  OutT* st = stage[threadIdx.y];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = i * 32 + lane;
    if (p < npix) {
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (have) sample(P, img, TH, TW, seg + p, y, v);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) st[3 * p + ch] = to_out(epilogue<kEpi>(v[ch], epi), st);
    }
  }
  __syncwarp();
  // the segment's bytes, 16 at a time where they are aligned, else one element
  // at a time: either way consecutive lanes store consecutive addresses
  const int64_t e0 = (((int64_t)b * S + y) * S + seg) * 3;
  OutT* o = out + e0;
  const int nbytes = npix * 3 * (int)sizeof(OutT);
  if (((e0 * (int64_t)sizeof(OutT)) & 15) == 0 && (nbytes & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(st);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int j = lane; j < nbytes / 16; j += 32) o4[j] = s4[j];
  } else {
    for (int j = lane; j < npix * 3; j += 32) o[j] = st[j];
  }
}

template <int kEpi, typename OutT, int kPix>
cudaError_t launch(const void* src, const void* params, const void* src_idx, void* out, int B,
                   int N, int TH, int TW, int S, Epilogue epi, cudaStream_t stream) {
  const dim3 grid((S + 32 * kPix - 1) / (32 * kPix), (S + kWarps - 1) / kWarps, B);
  warp_crop_kernel<kEpi, OutT, kPix><<<grid, dim3(32, kWarps), 0, stream>>>(
      (const uint8_t*)src, (const float*)params, (const int32_t*)src_idx, (OutT*)out, N, TH, TW,
      S, epi);
  return cudaGetLastError();
}

}  // namespace

// src: uint8 [N, TH, TW, 3]; params: float32 [B, 18]; src_idx: int32 [B];
// out: [B, S, S, 3], float32 (out_bf16 = 0) or bf16 (out_bf16 = 1, only with
// a normalize epilogue); epi: 0 none, 1 unit, 2 normalize, 3 normalize_div. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a form it
// does not take.
extern "C" int metro_warp_crop(const void* src, const void* params, const void* src_idx,
                               void* out, int B, int N, int TH, int TW, int S, int epi,
                               int out_bf16, float unit, float scale, float offset,
                               void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const Epilogue e{unit, scale, offset};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (out_bf16) {
    if (epi == kNormalize)
      err = launch<kNormalize, __nv_bfloat16, 8>(src, params, src_idx, out, B, N, TH, TW, S, e, s);
    else if (epi == kNormalizeDiv)
      err = launch<kNormalizeDiv, __nv_bfloat16, 8>(src, params, src_idx, out, B, N, TH, TW, S, e,
                                                    s);
  } else if (epi == kNone) {
    err = launch<kNone, float, 4>(src, params, src_idx, out, B, N, TH, TW, S, e, s);
  } else if (epi == kUnit) {
    err = launch<kUnit, float, 4>(src, params, src_idx, out, B, N, TH, TW, S, e, s);
  } else if (epi == kNormalize) {
    err = launch<kNormalize, float, 4>(src, params, src_idx, out, B, N, TH, TW, S, e, s);
  } else if (epi == kNormalizeDiv) {
    err = launch<kNormalizeDiv, float, 4>(src, params, src_idx, out, B, N, TH, TW, S, e, s);
  }
  return (int)err;
}
