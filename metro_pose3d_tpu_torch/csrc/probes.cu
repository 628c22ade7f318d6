// Primitive probes: small kernels that measure what the card does with the
// access patterns a warp sampler is built from. Nothing on the serving or
// training path calls them; `metro_pose3d_tpu_torch/probes/` times them.
//
// Replaces: the Pallas probe kernels of scripts/exp_pallas_gather.py
// (`build_sublane`, `build_lane`, `build_lane_f32`), scripts/exp_pallas_gather2.py
// (`probe`) and scripts/exp_pallas_prims.py (`build_lane_loop`, `build_roll`,
// `build_dynslice`; its `build_rowsel` is csrc/rowsel_mma.cu). Each of those
// runs one batch element per grid step on a block held in VMEM; here a thread
// block takes a tile of one batch element, and where the TPU kernel loops over
// a block held on chip the tile is staged in shared memory once and the loop
// reads it from there.
//
// What bounds them on the card: the gathers move 12 bytes per element (value,
// index, result) and are bound by bytes; the looped probes do 64 shared-memory
// reads per element they load and are bound by operations (shared-memory
// reads and integer adds).
//
// All data is 32 bits wide, so the int32 and float32 gathers share one kernel
// that copies 32-bit words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// out[b,i,j] = x[b, idx[b,i,j], j] (axis 0) or x[b, i, idx[b,i,j]] (axis 1).
// Indices are taken as given: the caller keeps them inside the axis.
__global__ void gather_kernel(const uint32_t* __restrict__ x, const int* __restrict__ idx,
                              uint32_t* __restrict__ out, int64_t total, int H, int W, int axis) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int col = (int)(i % W);
  const int64_t r = i / W;
  const int row = (int)(r % H);
  const int64_t base = (r / H) * H * W;
  const int k = idx[i];
  out[i] = axis == 0 ? x[base + (int64_t)k * W + col] : x[base + (int64_t)row * W + k];
}

// out[b,i,j] = sum_{k<reps} x[b, i, (idx[b,i,j] + k) % W] from rows held in
// shared memory. One block takes kLoopRows rows of one batch element.
constexpr int kLoopRows = 32;
constexpr int kLoopMaxW = 256;  // kLoopRows * kLoopMaxW * 4 bytes = 32 KB

__global__ void lane_loop_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                                 int* __restrict__ out, int H, int W, int reps) {
  __shared__ int tile[kLoopRows * kLoopMaxW];
  const int row0 = blockIdx.x * kLoopRows;
  const int rows = min(kLoopRows, H - row0);
  const int64_t base = ((int64_t)blockIdx.y * H + row0) * W;
  const int n = rows * W;
  for (int e = threadIdx.x; e < n; e += blockDim.x) tile[e] = x[base + e];
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int* trow = tile + (e / W) * W;
    const int start = idx[base + e];
    int acc = 0;
    for (int k = 0; k < reps; ++k) acc += trow[(start + k) % W];
    out[base + e] = acc;
  }
}

// out[b,i,j] = sum_{k<reps} x[b, i, (j - shift[b] - k) mod W]: the sum of
// rolls of x[b] along its columns by shift[b] + k. Rows held in shared memory.
constexpr int kRollRows = 16;
constexpr int kRollMaxW = 512;  // kRollRows * kRollMaxW * 4 bytes = 32 KB

__global__ void roll_kernel(const int* __restrict__ x, const int* __restrict__ shift,
                            int* __restrict__ out, int H, int W, int reps) {
  __shared__ int tile[kRollRows * kRollMaxW];
  const int row0 = blockIdx.x * kRollRows;
  const int rows = min(kRollRows, H - row0);
  const int64_t base = ((int64_t)blockIdx.y * H + row0) * W;
  const int n = rows * W;
  for (int e = threadIdx.x; e < n; e += blockDim.x) tile[e] = x[base + e];
  __syncthreads();
  const int sh = shift[blockIdx.y] % W;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int* trow = tile + (e / W) * W;
    const int j = e % W;
    int acc = 0;
    for (int k = 0; k < reps; ++k) acc += trow[((j - sh - k) % W + W) % W];
    out[base + e] = acc;
  }
}

// out[b, r, c] = sum_{k<reps} x[b, (start[b] + k) % (H - R) + r, c], r < R:
// the sum of row slices with a start known only at run time. A block holds
// kSliceCols columns of all H rows in shared memory.
constexpr int kSliceCols = 16;
constexpr int kSliceMaxH = 512;  // kSliceMaxH * kSliceCols * 4 bytes = 32 KB

__global__ void dynslice_kernel(const int* __restrict__ x, const int* __restrict__ start,
                                int* __restrict__ out, int H, int W, int R, int reps) {
  __shared__ int tile[kSliceMaxH * kSliceCols];
  const int col0 = blockIdx.x * kSliceCols;
  const int cols = min(kSliceCols, W - col0);
  const int64_t base = (int64_t)blockIdx.y * H * W;
  for (int e = threadIdx.x; e < H * cols; e += blockDim.x) {
    const int r = e / cols, c = e % cols;
    tile[r * kSliceCols + c] = x[base + (int64_t)r * W + col0 + c];
  }
  __syncthreads();
  const int st = start[blockIdx.y];
  for (int e = threadIdx.x; e < R * cols; e += blockDim.x) {
    const int r = e / cols, c = e % cols;
    int acc = 0;
    for (int k = 0; k < reps; ++k) acc += tile[(((st + k) % (H - R)) + r) * kSliceCols + c];
    out[((int64_t)blockIdx.y * R + r) * W + col0 + c] = acc;
  }
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape its kernel's shared-memory tile cannot hold.

extern "C" int metro_probe_gather(const void* x, const void* idx, void* out, int B, int H, int W,
                                  int axis, void* stream) {
  const int64_t total = (int64_t)B * H * W;
  if (total == 0) return (int)cudaSuccess;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const int*)idx, (uint32_t*)out, total, H, W, axis);
  return (int)cudaGetLastError();
}

extern "C" int metro_probe_lane_loop(const void* x, const void* idx, void* out, int B, int H,
                                     int W, int reps, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  if (W < 1 || W > kLoopMaxW) return (int)cudaErrorInvalidValue;
  const dim3 grid((H + kLoopRows - 1) / kLoopRows, B);
  lane_loop_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const int*)x, (const int*)idx,
                                                               (int*)out, H, W, reps);
  return (int)cudaGetLastError();
}

extern "C" int metro_probe_roll(const void* x, const void* shift, void* out, int B, int H, int W,
                                int reps, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  if (W < 1 || W > kRollMaxW) return (int)cudaErrorInvalidValue;
  const dim3 grid((H + kRollRows - 1) / kRollRows, B);
  roll_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const int*)x, (const int*)shift,
                                                          (int*)out, H, W, reps);
  return (int)cudaGetLastError();
}

extern "C" int metro_probe_dynslice(const void* x, const void* start, void* out, int B, int H,
                                    int W, int R, int reps, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (H > kSliceMaxH || R < 1 || R >= H || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kSliceCols - 1) / kSliceCols, B);
  dynslice_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const int*)x, (const int*)start,
                                                              (int*)out, H, W, R, reps);
  return (int)cudaGetLastError();
}
