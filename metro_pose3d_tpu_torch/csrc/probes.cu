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
// index, result) and are bound by bytes; the looped probes repeat an access
// 64 times per element they load: the lane loop is bound by its
// shared-memory reads, the roll by its bytes, with its int32 adds just
// below them (each kernel's note says how). Start indices and shifts are taken modulo the axis as
// Python takes them: a negative one counts from the end.
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

// Python's modulo: the result lies in [0, m) for any a and any m > 0.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// acc + w as one add the compiler keeps: the looped probes measure the rate
// of one shared word read and added per rep, so no two outputs may share a
// partial sum (which integer reassociation would otherwise allow).
__device__ __forceinline__ int add_word(int acc, int w) {
  int s;
  asm("add.s32 %0, %1, %2;" : "=r"(s) : "r"(acc), "r"(w));
  return s;
}

// The looped probes stage rows in dynamic shared memory, at most this much
// a block (what a block may take without opting in to more).
constexpr int kLoopSmemBytes = 48 * 1024;
constexpr int kLoopThreads = 256;
// 4-column groups of outputs a roll thread takes in its block's tile
constexpr int kRollGroups = 4;

// Stage rows [row0, row0 + rows) of x (W words each; xb points at row0) in
// shared memory, `pitch` words a row, as e[r][t] = x[r][t mod W] for every
// t < pitch. Each loaded word goes to t = p, p + W, p + 2W, ...: a row
// extends by whole turns without a division. 16-byte loads where `vec`.
__device__ __forceinline__ void stage_rows(const int* __restrict__ xb, int* e, int rows, int W,
                                           int pitch, bool vec) {
  const int n = rows * W;
  if (vec) {
    for (int v = threadIdx.x; v < (n >> 2); v += blockDim.x) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(xb) + v);
      const int r = (v << 2) / W;
      const int p = (v << 2) - r * W;
      int* er = e + r * pitch;
      const int w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        for (int t = p + i; t < pitch; t += W) er[t] = w4[i];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / W;
      const int w = __ldg(xb + i);
      int* er = e + r * pitch;
      for (int t = i - r * W; t < pitch; t += W) er[t] = w;
    }
  }
}

// One 32-bit word at shared-memory byte address `addr`: the lane loop picks
// each rep's address as a 32-bit shared address, and the load takes it as
// is, with no generic-pointer arithmetic in between.
__device__ __forceinline__ int lds(unsigned addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

constexpr int kLoopPer = 4;  // lane-loop elements a thread takes in one pass

// out[b,i,j] = sum_{k<reps} x[b, i, (idx[b,i,j] + k) mod W]: each element
// sums a window of reps words of its row that starts at its own index.
// Replaces scripts/exp_pallas_prims.py::build_lane_loop.
//
// Bound: 4 shared-memory bytes read a rep (the card reads 128 B a clock an
// SM), above the int32 adds and the 12 bytes an element moves to and from
// device memory. So the design keeps every shared read free of bank
// conflicts, and the instructions around it fewer than the clock it takes:
// - A block stages `rows` rows, each extended to W + reps - 1 words, so a
//   window is contiguous: start a = idx mod W (one floor modulo an element,
//   skipped when idx is already in [0, W)), words e[a .. a + reps).
// - Lanes start at random columns, so reading windows in order would put
//   several lanes of a warp on one bank. Instead, at step k of each 32-word
//   block of its window, lane l reads offset (k + l - a_l) & 31, a_l the
//   window start's shared word address: its bank is (k + l) mod 32, distinct
//   across the warp. The wrap is a select between two byte addresses, one
//   for a pair of 32-word blocks; the compiler keeps the 32 selected
//   addresses in registers, so two reps cost two loads, an address add and
//   one three-input add. No modulo. Integer sums are exact in any order.
//   reps % 32 words are read in order after.
// - A thread takes kLoopPer elements of the block's rows and loads their
//   starts before the barrier, beside the rows' loads, so one wait on
//   device memory covers 4 x 64 reps; the loop over them is unrolled, so
//   the starts stay in registers (63 a thread, no stack).
__global__ void __launch_bounds__(kLoopThreads)
lane_loop_kernel(const int* __restrict__ x, const int* __restrict__ idx, int* __restrict__ out,
                 int H, int W, int reps, int rows_per_block, int pitch, int vec) {
  extern __shared__ int4 smem4[];
  int* e = reinterpret_cast<int*>(smem4);
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, H - row0);
  const size_t base = ((size_t)blockIdx.y * H + row0) * W;
  const int n = rows * W;
  const int* ib = idx + base;
  int* ob = out + base;
  stage_rows(x + base, e, rows, W, pitch, vec);
  const unsigned e_addr = (unsigned)__cvta_generic_to_shared(e);
  const int lane = threadIdx.x & 31;
  const int blocks32 = reps >> 5;
  for (int i0 = 0; i0 < n; i0 += kLoopPer * kLoopThreads) {
    int start[kLoopPer];
#pragma unroll
    for (int u = 0; u < kLoopPer; ++u) {
      const int i = i0 + u * kLoopThreads + threadIdx.x;
      start[u] = i < n ? __ldg(ib + i) : 0;
    }
    if (i0 == 0) __syncthreads();  // the staged rows
#pragma unroll
    for (int u = 0; u < kLoopPer; ++u) {
      const int i = i0 + u * kLoopThreads + threadIdx.x;
      if (i >= n) break;
      int a = start[u];
      if ((unsigned)a >= (unsigned)W) a = floor_mod(a, W);
      const unsigned win = e_addr + 4u * (unsigned)((i / W) * pitch + a);  // bytes
      const int o0 = (int)(((unsigned)lane - (win >> 2)) & 31u);
      const int n1 = 32 - o0;  // steps before the wrap
      const unsigned sa = win + 4u * o0, sb = sa - 128u;
      int acc = 0;
      int h = 0;
      for (; h + 2 <= blocks32; h += 2) {
        const unsigned ha = sa + (h << 7), hb = sb + (h << 7);
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const unsigned p = (k < n1 ? ha : hb) + 4u * k;
          acc = add_word(add_word(acc, lds(p)), lds(p + 128u));
        }
      }
      if (h < blocks32) {
        const unsigned ha = sa + (h << 7), hb = sb + (h << 7);
#pragma unroll
        for (int k = 0; k < 32; ++k) acc = add_word(acc, lds((k < n1 ? ha : hb) + 4u * k));
      }
      for (int k = blocks32 << 5; k < reps; ++k) acc = add_word(acc, lds(win + 4u * k));
      ob[i] = acc;
    }
  }
}

// Asynchronous copies from device to shared memory (cp.async): 16 bytes
// go to shared memory with no round trip through registers.
__device__ __forceinline__ void cp_async16(unsigned dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The roll's first staged column: out[b,i,j] sums e[j .. j + reps) with
// e[t] = x[b,i,(t + c0) mod W], c0 = (-shift - (reps - 1)) mod W (two floor
// moduli a block, right for any int32 shift).
__device__ __forceinline__ int roll_c0(int shift, int W, int reps) {
  return floor_mod(-(floor_mod(shift, W) + floor_mod(reps - 1, W)), W);
}

// Copy `rows` rows of x (xr points at the first) into E (shared byte
// address), rolled by c4 = c0 rounded down to a multiple of 4 and extended
// by whole turns: E[r][u] = x[r][(u + c4) mod W] for every u < pitch, so
// e[t] = E[t + c0 % 4]. Each source word (or 16-byte vector, where `vec`:
// W % 4 == 0 and x aligned) goes to u = p - c4, + W, + 2W, ...: no division.
__device__ __forceinline__ void roll_stage(const int* __restrict__ xr, int c4, unsigned E,
                                           int rows, int W, int pitch, bool vec) {
  for (int r = 0; r < rows; ++r, xr += W, E += 4u * pitch) {
    if (vec) {
      for (int p = threadIdx.x << 2; p < W; p += blockDim.x << 2) {
        int u = p - c4;
        if (u < 0) u += W;
        for (; u < pitch; u += W) cp_async16(E + 4u * u, xr + p);
      }
    } else {
      for (int p = threadIdx.x; p < W; p += blockDim.x) {
        int u = p - c4;
        if (u < 0) u += W;
        for (; u < pitch; u += W) cp_async4(E + 4u * u, xr + p);
      }
    }
  }
}

// A thread's walk over the 4-column groups of a tile's rows, row-major:
// it starts at (r0, g0) and steps by blockDim.x groups, (dr, dg); fixed for
// the kernel, so no output divides by the group count.
struct GroupWalk {
  int groups, r0, g0, dr, dg;
};

__device__ __forceinline__ GroupWalk group_walk(int W) {
  GroupWalk w;
  w.groups = (W + 3) >> 2;
  w.r0 = threadIdx.x / w.groups;
  w.g0 = threadIdx.x - w.r0 * w.groups;
  w.dr = blockDim.x / w.groups;
  w.dg = blockDim.x - w.dr * w.groups;
  return w;
}

// The sums of a block's outputs from E, rows of `pitch` words staged by
// roll_stage; D = c0 % 4, so out[j] = sum_{k<reps} E[j + D + k]. A thread
// owns 4 consecutive outputs j0 .. j0+3 and slides a window of 12 registers
// (three aligned 16-byte vectors) along E, one 16-byte shared load every 4
// reps; D picks the window's words at compile time.
template <int D>
__device__ __forceinline__ void roll_sums(const int* E, int* ob, int rows, int W, int pitch,
                                          int reps, bool vec, GroupWalk gw) {
  const int quads = reps >> 2, rest = reps & 3;
  for (int r = gw.r0, g = gw.g0; r < rows;) {
    const int j0 = g << 2;
    const int4* w = reinterpret_cast<const int4*>(E + r * pitch + j0);
    int4 a = w[0], b = w[1], c = w[2];  // E[j0 + 4q .. j0 + 4q + 11]
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 2
    for (int q = 0; q < quads; ++q) {
      // reps 4q .. 4q+3: out[j0 + v] takes E[j0 + 4q + D + v + u], u < 4
      const int e[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
      s0 = add_word(add_word(add_word(add_word(s0, e[D]), e[D + 1]), e[D + 2]), e[D + 3]);
      s1 = add_word(add_word(add_word(add_word(s1, e[D + 1]), e[D + 2]), e[D + 3]), e[D + 4]);
      s2 = add_word(add_word(add_word(add_word(s2, e[D + 2]), e[D + 3]), e[D + 4]), e[D + 5]);
      s3 = add_word(add_word(add_word(add_word(s3, e[D + 3]), e[D + 4]), e[D + 5]), e[D + 6]);
      a = b;
      b = c;
      c = w[q + 3];
    }
    const int e[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (u < rest) {
        s0 = add_word(s0, e[D + u]);
        s1 = add_word(s1, e[D + u + 1]);
        s2 = add_word(s2, e[D + u + 2]);
        s3 = add_word(s3, e[D + u + 3]);
      }
    }
    if (vec) {
      *reinterpret_cast<int4*>(ob + r * W + j0) = make_int4(s0, s1, s2, s3);
    } else {
      const int acc[4] = {s0, s1, s2, s3};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j0 + v < W) ob[r * W + j0 + v] = acc[v];
    }
    g += gw.dg;
    r += gw.dr;
    if (g >= gw.groups) {
      g -= gw.groups;
      ++r;
    }
  }
}

// out[b,i,j] = sum_{k<reps} x[b, i, (j - shift[b] - k) mod W]: the sum of
// rolls of x[b] along its columns by shift[b] + k.
// Replaces scripts/exp_pallas_prims.py::build_roll.
//
// Bound: the 8 bytes an element moves to and from device memory, just above
// the reps int32 adds of every output (the card adds 128 a clock an SM in
// three-input adds). The design:
// - A block takes a tile of rows (kRollGroups 4-column groups a thread:
//   8 rows at W = 512) and stages it rolled and extended by reps + 8 words
//   (roll_stage), so out[j] sums a window of E that never wraps, however
//   many turns reps makes of the row. The roll is rounded to 4 words so
//   that the copies are 16-byte cp.async, with no trip through registers;
//   roll_sums takes the rest in its register window. (Two rows a block,
//   staged through registers, spent more on each block's fixed work; a
//   ring of tiles a block, loading the next while adding one, and a tile
//   staged in parts, adding one while the next lands, were slower.)
// - Each loaded word feeds the outputs that need it, so a warp's loads
//   cover 512 consecutive bytes (no bank conflicts) and the adds, not the
//   loads, bound the loop (ptxas pairs them into three-input adds). Every
//   output still adds all reps words: no running or prefix sum.
// - 16-byte copies and stores where W % 4 == 0 and x and out are aligned;
//   32-bit indices within a tile.
__global__ void __launch_bounds__(kLoopThreads)
roll_kernel(const int* __restrict__ x, const int* __restrict__ shift, int* __restrict__ out,
            int H, int W, int reps, int rows_per_block, int pitch, int vec) {
  extern __shared__ int4 smem4[];
  int* const E = reinterpret_cast<int*>(smem4);
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, H - row0);
  const size_t base = ((size_t)blockIdx.y * H + row0) * W;
  const int c0 = roll_c0(__ldg(shift + blockIdx.y), W, reps);
  roll_stage(x + base, c0 & ~3, (unsigned)__cvta_generic_to_shared(E), rows, W, pitch, vec);
  cp_async_wait_all();
  __syncthreads();
  const GroupWalk gw = group_walk(W);
  switch (c0 & 3) {
    case 0: roll_sums<0>(E, out + base, rows, W, pitch, reps, vec, gw); break;
    case 1: roll_sums<1>(E, out + base, rows, W, pitch, reps, vec, gw); break;
    case 2: roll_sums<2>(E, out + base, rows, W, pitch, reps, vec, gw); break;
    default: roll_sums<3>(E, out + base, rows, W, pitch, reps, vec, gw); break;
  }
}

// out[b, r, c] = sum_{k<reps} x[b, (start[b] + k) mod (H - R) + r, c], r < R:
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
  const int st = floor_mod(start[blockIdx.y], H - R);  // any int32 start, as Python's %
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

namespace {

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Rows a looped-probe block stages: enough for its threads at
// `items_per_row` work items a row and `per_thread` items a thread, halved
// while the grid would give an SM fewer than two blocks, and no more than
// its shared memory holds.
int loop_rows(int B, int H, int items_per_row, int per_thread, int pitch) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int rows = max(1, kLoopThreads * per_thread / items_per_row);
  while (rows > 1 && (int64_t)B * ((H + rows - 1) / rows) < 2 * sms) rows >>= 1;
  return min(rows, kLoopSmemBytes / (pitch * 4));
}

}  // namespace

extern "C" int metro_probe_lane_loop(const void* x, const void* idx, void* out, int B, int H,
                                     int W, int reps, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  const int pitch = W + max(reps, 1) - 1;  // a window of reps words from any column
  if (W < 1 || reps < 0 || B > 65535 || pitch > kLoopSmemBytes / 4)
    return (int)cudaErrorInvalidValue;
  const int rows = loop_rows(B, H, W, kLoopPer, pitch);
  const dim3 grid((H + rows - 1) / rows, B);
  lane_loop_kernel<<<grid, kLoopThreads, rows * pitch * 4, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)idx, (int*)out, H, W, reps, rows, pitch,
      W % 4 == 0 && aligned16(x));
  return (int)cudaGetLastError();
}

extern "C" int metro_probe_roll(const void* x, const void* shift, void* out, int B, int H, int W,
                                int reps, void* stream) {
  if (B == 0 || H == 0) return (int)cudaSuccess;
  // 4-column groups, then the last group's window: 4 words a quad of reps
  // and 12 more, the first up to 3 of them skipped (c0 % 4)
  const int pitch = 4 * ((W + 3) / 4) + 4 * (reps / 4) + 8;
  if (W < 1 || reps < 0 || B > 65535 || pitch > kLoopSmemBytes / 4)
    return (int)cudaErrorInvalidValue;
  const int rows = min(max(1, kLoopThreads * kRollGroups / ((W + 3) / 4)),
                       kLoopSmemBytes / (pitch * 4));
  const dim3 grid((H + rows - 1) / rows, B);
  roll_kernel<<<grid, kLoopThreads, rows * pitch * 4, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)shift, (int*)out, H, W, reps, rows, pitch,
      W % 4 == 0 && aligned16(x) && aligned16(out));
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
