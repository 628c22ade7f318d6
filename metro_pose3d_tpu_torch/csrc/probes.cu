// Primitive probes: small kernels that measure what the card does with the
// access patterns a warp sampler is built from. Nothing on the serving or
// training path calls them; `metro_pose3d_tpu_torch/probes/` times them.
//
// Replaces: the Pallas probe kernels of scripts/exp_pallas_gather.py
// (`build_sublane`, `build_lane`, `build_lane_f32`), scripts/exp_pallas_gather2.py
// (`probe`) and scripts/exp_pallas_prims.py (`build_lane_loop`, `build_roll`,
// `build_dynslice`; its `build_rowsel` is csrc/rowsel_mma.cu). Each of those
// runs one batch element per grid step on a block held in VMEM; here a thread
// block takes a tile of one batch element, stages it in shared memory once
// and reads it from there.
//
// What bounds them on the card: the gathers move 12 bytes per element (value,
// index, result) and are bound by bytes; the looped probes repeat an access
// 64 times per element they load: the lane loop is bound by its
// shared-memory reads, the roll and the row slice by their bytes, with their
// int32 adds below them (each kernel's note says how).
//
// Rep k's position follows the JAX kernels' int32 arithmetic: the index,
// shift or start s plus k wraps past INT32_MAX to INT32_MIN (`add_wrap`),
// and is then taken modulo the axis as Python takes it (a negative one counts
// from the end). Within a run of reps the wrap happens at most once, after
// kw = 2^31 - s reps (`reps_before_wrap`); from there the positions are those
// of a start of INT32_MIN. No kernel takes a modulo inside its rep loop.
//
// All data is 32 bits wide, so the int32 and float32 gathers share kernels
// that copy 32-bit words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInt32Max = 2147483647;
constexpr int kInt32Min = -kInt32Max - 1;
// dynamic shared memory a block has without opting in, and the most it may
// opt in to (cudaFuncSetAttribute)
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;

// Python's modulo: the result lies in [0, m) for any a and any m > 0.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// a + b as two's-complement int32 addition (jnp's int32 `+`): the sum wraps
// past INT32_MAX to INT32_MIN. Done in unsigned, where C++ defines the wrap.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The reps of a run that starts at s before s + k passes INT32_MAX, at most
// reps: kw = 2^31 - s >= 1, and rep kw's position is that of INT32_MIN.
__device__ __forceinline__ int reps_before_wrap(int s, int reps) {
  const long long kw = 2147483648LL - s;
  return kw < reps ? (int)kw : reps;
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
// - An element whose window passes INT32_MAX (start above INT32_MAX - reps
//   + 1; none in the script's draws) takes a short path instead: rep by rep,
//   its position a floor modulo of the wrapped sum.
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
  const int wraps_above = kInt32Max - max(reps - 1, 0);  // a start above it wraps
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
      const unsigned row = e_addr + 4u * (unsigned)((i / W) * pitch);  // bytes
      if (a > wraps_above) {
        int acc = 0;
        for (int k = 0; k < reps; ++k)
          acc = add_word(acc, lds(row + 4u * (unsigned)floor_mod(add_wrap(a, k), W)));
        ob[i] = acc;
        continue;
      }
      if ((unsigned)a >= (unsigned)W) a = floor_mod(a, W);
      const unsigned win = row + 4u * (unsigned)a;
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

// A thread's walk over the groups (4 columns, or one) of a tile's rows, row-major:
// it starts at (r0, g0) and steps by blockDim.x groups, (dr, dg); fixed for
// the kernel, so no output divides by the group count.
struct GroupWalk {
  int groups, r0, g0, dr, dg;
};

__device__ __forceinline__ GroupWalk group_walk(int groups) {
  GroupWalk w;
  w.groups = groups;
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
// reps; D picks the window's words at compile time. With `add`, the sums
// add to the outputs this thread stored before (the run after an int32 wrap).
template <int D>
__device__ __forceinline__ void roll_sums(const int* E, int* ob, int rows, int W, int pitch,
                                          int reps, bool vec, bool add, GroupWalk gw) {
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
      int4* o = reinterpret_cast<int4*>(ob + r * W + j0);
      if (add) {
        const int4 p = *o;
        s0 = add_word(s0, p.x);
        s1 = add_word(s1, p.y);
        s2 = add_word(s2, p.z);
        s3 = add_word(s3, p.w);
      }
      *o = make_int4(s0, s1, s2, s3);
    } else {
      const int acc[4] = {s0, s1, s2, s3};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j0 + v < W) ob[r * W + j0 + v] = add ? add_word(ob[r * W + j0 + v], acc[v]) : acc[v];
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
// - A shift within reps of INT32_MAX splits the reps in two runs at the
//   int32 wrap (reps_before_wrap): the block sums the first, then stages
//   its rows again rolled for a shift of INT32_MIN and adds the second.
__global__ void __launch_bounds__(kLoopThreads)
roll_kernel(const int* __restrict__ x, const int* __restrict__ shift, int* __restrict__ out,
            int H, int W, int reps, int rows_per_block, int pitch, int vec) {
  extern __shared__ int4 smem4[];
  int* const E = reinterpret_cast<int*>(smem4);
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, H - row0);
  const size_t base = ((size_t)blockIdx.y * H + row0) * W;
  const int s = __ldg(shift + blockIdx.y);
  const int reps1 = reps_before_wrap(s, reps);
  const GroupWalk gw = group_walk((W + 3) >> 2);
  for (int run = 0; run < 2; ++run) {
    const int run_reps = run == 0 ? reps1 : reps - reps1;
    if (run == 1) {
      if (run_reps == 0) break;
      __syncthreads();  // every thread is done with E
    }
    const int c0 = roll_c0(run == 0 ? s : kInt32Min, W, run_reps);
    roll_stage(x + base, c0 & ~3, (unsigned)__cvta_generic_to_shared(E), rows, W, pitch, vec);
    cp_async_wait_all();
    __syncthreads();
    const bool add = run == 1;
    switch (c0 & 3) {
      case 0: roll_sums<0>(E, out + base, rows, W, pitch, run_reps, vec, add, gw); break;
      case 1: roll_sums<1>(E, out + base, rows, W, pitch, run_reps, vec, add, gw); break;
      case 2: roll_sums<2>(E, out + base, rows, W, pitch, run_reps, vec, add, gw); break;
      default: roll_sums<3>(E, out + base, rows, W, pitch, run_reps, vec, add, gw); break;
    }
  }
}

// ---------------------------------------------------------------------------
// The gathers. Replace scripts/exp_pallas_gather.py::build_sublane (rows),
// build_lane and build_lane_f32 (columns), and the sweep of
// scripts/exp_pallas_gather2.py::probe (both axes).
//
// Bound: bytes. An element reads its index and its value and writes its
// result, 12 bytes, and touches nothing else. So both kernels stage the
// values a block gathers from in shared memory with 16-byte cp.async, in
// whole 128-byte lines where the shape allows, and stream the indices in and
// the results out as 16-byte vectors (one element at a time where W % 4 != 0
// or a pointer is not 16-byte aligned). The gather itself is a shared-memory
// read, which costs the card little beside the bytes. Indices are taken as
// given: the caller keeps them inside the axis.
constexpr int kGatherThreads = 256;
constexpr int kGatherStrip = 32;  // columns a row-gather block stages: one 128-byte line a row
constexpr int kGatherUnroll = 4;  // index vectors a thread loads before it gathers them

// (v[r], v[r+1], v[r+2], v[r+3]), indices mod 4: a rotation by selects, with
// no register array indexed at run time.
__device__ __forceinline__ int4 rot4(int4 v, int r) {
  const int4 a = (r & 1) ? make_int4(v.y, v.z, v.w, v.x) : v;
  return (r & 2) ? make_int4(a.z, a.w, a.x, a.y) : a;
}

// out[b,i,j] = x[b, idx[b,i,j], j]. A block owns the strip of kGatherStrip
// columns blockIdx.x of batch element blockIdx.y: it stages all H rows of
// the strip (H x 128 bytes, opted in above 48 KB) and then streams the
// strip's indices. With VEC, thread t takes the 4 columns 4q .. 4q+3
// (q = t % 8) of rows t / 8, t / 8 + 32, ...; a warp's 32 lanes cover 4 rows
// x 32 columns, and the 4 lanes of a column quad read its columns in 4
// rotated orders, so each shared read of the warp touches the 32 columns
// once: 32 distinct banks, whatever rows the indices pick. Without VEC, a
// warp takes one row of the strip, a lane a column.
template <bool VEC>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_rows_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                         int* __restrict__ out, int H, int W) {
  extern __shared__ int4 smem4[];
  const int* const tile = reinterpret_cast<const int*>(smem4);  // [H][kGatherStrip]
  const unsigned t_addr = (unsigned)__cvta_generic_to_shared(smem4);
  const int col0 = blockIdx.x * kGatherStrip;
  const int cols = min(kGatherStrip, W - col0);
  const size_t base = (size_t)blockIdx.y * H * W + col0;
  const int* const xb = x + base;
  const int* const ib = idx + base;
  int* const ob = out + base;
  if (VEC) {
    constexpr int kRowsPass = kGatherThreads / 8;  // rows a pass of the block covers
    const int q = threadIdx.x & 7, r0 = threadIdx.x >> 3;
    const bool on = 4 * q < cols;
    if (on)
      for (int r = r0; r < H; r += kRowsPass)
        cp_async16(t_addr + 4u * (unsigned)(r * kGatherStrip + 4 * q), xb + r * W + 4 * q);
    const int rot = r0 & 3;  // this lane's row among the warp's 4
    int colk[4];             // the column read at step k
#pragma unroll
    for (int k = 0; k < 4; ++k) colk[k] = 4 * q + ((k + rot) & 3);
    for (int i0 = 0; i0 < H; i0 += kRowsPass * kGatherUnroll) {
      int4 v[kGatherUnroll];
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int i = i0 + r0 + u * kRowsPass;
        v[u] = on && i < H ? __ldg(reinterpret_cast<const int4*>(ib + i * W + 4 * q))
                           : make_int4(0, 0, 0, 0);
      }
      if (i0 == 0) {  // the staged strip
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int i = i0 + r0 + u * kRowsPass;
        if (!on || i >= H) break;
        const int4 a = rot4(v[u], rot);  // a[k]: the index of column colk[k]
        const int4 g = make_int4(tile[a.x * kGatherStrip + colk[0]],
                                 tile[a.y * kGatherStrip + colk[1]],
                                 tile[a.z * kGatherStrip + colk[2]],
                                 tile[a.w * kGatherStrip + colk[3]]);
        *reinterpret_cast<int4*>(ob + i * W + 4 * q) = rot4(g, (4 - rot) & 3);
      }
    }
  } else {
    constexpr int kRowsPass = kGatherThreads / kGatherStrip;
    const int c = threadIdx.x & (kGatherStrip - 1), r0 = threadIdx.x / kGatherStrip;
    const bool on = c < cols;
    if (on)
      for (int r = r0; r < H; r += kRowsPass)
        cp_async4(t_addr + 4u * (unsigned)(r * kGatherStrip + c), xb + r * W + c);
    for (int i0 = 0; i0 < H; i0 += kRowsPass * kGatherUnroll) {
      int v[kGatherUnroll];
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int i = i0 + r0 + u * kRowsPass;
        v[u] = on && i < H ? __ldg(ib + i * W + c) : 0;
      }
      if (i0 == 0) {
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int i = i0 + r0 + u * kRowsPass;
        if (!on || i >= H) break;
        ob[i * W + c] = tile[v[u] * kGatherStrip + c];
      }
    }
  }
}

// The next kGatherUnroll groups of a column-gather thread's walk (r, g):
// their rows, offsets and indices (loaded where the row is the block's).
template <bool VEC>
__device__ __forceinline__ void cols_next(const int* __restrict__ ib, int W, int rows,
                                          const GroupWalk& gw, int& r, int& g,
                                          int (&rr)[kGatherUnroll], int (&off)[kGatherUnroll],
                                          int4 (&v)[kGatherUnroll]) {
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    rr[u] = r;
    off[u] = r * W + (VEC ? 4 * g : g);
    if (r < rows)
      v[u] = VEC ? __ldg(reinterpret_cast<const int4*>(ib + off[u]))
                 : make_int4(__ldg(ib + off[u]), 0, 0, 0);
    g += gw.dg;
    r += gw.dr;
    if (g >= gw.groups) {
      g -= gw.groups;
      ++r;
    }
  }
}

// out[b,i,j] = x[b, i, idx[b,i,j]]. A block owns rows_per_block whole rows
// of batch element blockIdx.y, contiguous in x, and stages them as they lie
// (16-byte copies with VEC). A thread walks the block's 4-column groups
// (VEC) or elements, row-major, by blockDim.x at a time (GroupWalk: no
// division an element), with the indices of kGatherUnroll steps loaded
// before it gathers them.
template <bool VEC>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_cols_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                         int* __restrict__ out, int H, int W, int rows_per_block) {
  extern __shared__ int4 smem4[];
  const int* const tile = reinterpret_cast<const int*>(smem4);  // [rows][W]
  const unsigned t_addr = (unsigned)__cvta_generic_to_shared(smem4);
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, H - row0);
  const size_t base = ((size_t)blockIdx.y * H + row0) * W;
  const int n = rows * W;
  if (VEC) {
    for (int v = threadIdx.x; v < (n >> 2); v += blockDim.x)
      cp_async16(t_addr + 16u * (unsigned)v, x + base + 4 * v);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cp_async4(t_addr + 4u * (unsigned)e, x + base + e);
  }
  const int* const ib = idx + base;
  int* const ob = out + base;
  const GroupWalk gw = group_walk(VEC ? W >> 2 : W);
  int r = gw.r0, g = gw.g0;
  int rr[kGatherUnroll], off[kGatherUnroll];
  int4 v[kGatherUnroll];
  cols_next<VEC>(ib, W, rows, gw, r, g, rr, off, v);
  cp_async_wait_all();
  __syncthreads();
  while (rr[0] < rows) {
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      if (rr[u] >= rows) break;
      const int* const t = tile + rr[u] * W;
      if (VEC) {
        *reinterpret_cast<int4*>(ob + off[u]) =
            make_int4(t[v[u].x], t[v[u].y], t[v[u].z], t[v[u].w]);
      } else {
        ob[off[u]] = t[v[u].x];
      }
    }
    cols_next<VEC>(ib, W, rows, gw, r, g, rr, off, v);
  }
}

// A launch that does nothing, made on a probe's grid, block and shared
// memory: its device time is the launch floor beside the probe's.
__global__ void probe_empty_kernel() {}

// ---------------------------------------------------------------------------
// The run-time row slice. Replaces scripts/exp_pallas_prims.py::build_dynslice:
// out[b, r, c] = sum_{k<reps} x[b, p_k + r, c], r < R, where
// p_k = floor_mod(start[b] + k as int32, H - R).
//
// Bound: bytes, at the script's shape: the rows the starts touch (a run of
// reps positions touches run + R - 1 rows, about 136 of 512 at the script's
// starts), the starts and the output; its B x R x W x reps int32 adds come
// to half of that. So the design reads only the rows it needs, and feeds
// many adds from each shared-memory read:
// - Runs. The positions p_k rise by one from p_0 = floor_mod(start, H - R),
//   and break where they reach H - R (back to 0) and at the int32 wrap
//   (to floor_mod(INT32_MIN, H - R)): at most three runs when reps <= H - R;
//   at the script's draws, two for about one start in seven. A block walks
//   them with no modulo in its loop.
// - Staging. A block owns a strip of 4 x blockDim.x columns of one batch
//   element (narrowed on the host until the grid gives every SM two
//   blocks: 16 columns at the script's shape) and stages, for up to
//   kSliceRuns runs at a time, rows p .. p + len + R - 2 of its strip with
//   16-byte cp.async (4-byte where W % 4 != 0 or a pointer is unaligned).
//   The tile's rows are padded by 4 words, so the two row groups a quarter
//   warp reads lie on different banks.
// - The loop. A thread owns kSliceG consecutive output rows of 4 columns
//   (int4 sums in registers). Staged row j of a run feeds the outputs g with
//   g <= j < g + len: every one of them, away from the run's two ends, so one
//   16-byte shared read feeds 4 x kSliceG adds. Each output adds every rep's
//   word with its own add.s32: no running or prefix sum.
constexpr int kSliceG = 4;           // output rows a thread sums
constexpr int kSliceRuns = 3;        // runs a block stages at once
constexpr int kSliceMaxThreads = 1024;
constexpr int kSliceMaxH = 512;

__device__ __forceinline__ void add4(int4& acc, const int4 v) {
  acc.x = add_word(acc.x, v.x);
  acc.y = add_word(acc.y, v.y);
  acc.z = add_word(acc.z, v.z);
  acc.w = add_word(acc.w, v.w);
}

// acc[g] += sum_{q<len} T[(g + q) * stride] for g < kSliceG: row j of the
// run's tile feeds the outputs g <= j < g + len.
__device__ __forceinline__ void slice_run(int4 (&acc)[kSliceG], const int4* T, int stride,
                                          int len) {
#pragma unroll
  for (int j = 0; j < kSliceG - 1; ++j) {  // rows the first outputs alone take
    const int4 v = T[j * stride];
#pragma unroll
    for (int g = 0; g <= j; ++g)
      if (j < g + len) add4(acc[g], v);
  }
  int j = kSliceG - 1;
#pragma unroll 2
  for (; j < len; ++j) {
    const int4 v = T[j * stride];
#pragma unroll
    for (int g = 0; g < kSliceG; ++g) add4(acc[g], v);
  }
  for (; j < len + kSliceG - 1; ++j) {  // rows the last outputs alone take
    const int4 v = T[j * stride];
#pragma unroll
    for (int g = 0; g < kSliceG; ++g)
      if (g <= j && j < g + len) add4(acc[g], v);
  }
}

// Block (strip blockIdx.x, batch element blockIdx.y); thread (column group
// threadIdx.x, output rows kSliceG * threadIdx.y ...). The tile holds
// tile_rows rows of pitch = 4 * blockDim.x + 4 words.
__global__ void __launch_bounds__(kSliceMaxThreads)
probe_dynslice_kernel(const int* __restrict__ x, const int* __restrict__ start,
                      int* __restrict__ out, int H, int W, int R, int reps, int tile_rows,
                      int vec) {
  extern __shared__ int4 smem4[];
  const int quads = blockDim.x, stride = quads + 1;  // int4s a tile row
  const unsigned t_addr = (unsigned)__cvta_generic_to_shared(smem4);
  const int col0 = 4 * quads * blockIdx.x;
  const int cols = min(4 * quads, W - col0);
  const int tx = threadIdx.x, r0 = kSliceG * threadIdx.y;
  const int c = 4 * tx;  // this thread's first column in the strip
  const int* const xb = x + (size_t)blockIdx.y * H * W + col0;
  const int m = H - R;
  const int s = __ldg(start + blockIdx.y);
  const int kw = reps_before_wrap(s, reps);
  const int rpad = kSliceG * blockDim.y;  // output rows, padded
  int4 acc[kSliceG];
#pragma unroll
  for (int g = 0; g < kSliceG; ++g) acc[g] = make_int4(0, 0, 0, 0);
  int k = 0, p = floor_mod(s, m);  // the next rep, and its position
  while (k < reps) {
    // stage up to kSliceRuns runs (unrolled: the runs' lengths and tile
    // rows stay in registers), then sum them
    int run_len[kSliceRuns] = {}, run_row[kSliceRuns] = {};
    int used = 0;
#pragma unroll
    for (int i = 0; i < kSliceRuns; ++i) {
      if (k >= reps) break;
      int len = min(reps - k, m - p);
      if (k < kw) len = min(len, kw - k);
      const int need = len + rpad - 1;  // the tile always holds one run
      if (used + need > tile_rows) break;
      const int rows = min(need, H - p);  // rows past H feed only the padding
      for (int r = threadIdx.y; r < rows; r += blockDim.y) {
        const int* const src = xb + (p + r) * W;
        const unsigned dst = t_addr + 16u * (unsigned)((used + r) * stride + tx);
        if (vec) {
          if (c < cols) cp_async16(dst, src + c);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u < cols) cp_async4(dst + 4u * u, src + c + u);
        }
      }
      run_len[i] = len;
      run_row[i] = used;
      used += need;
      k += len;
      p += len;
      if (p == m) p = 0;
      if (k == kw) p = floor_mod(kInt32Min, m);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSliceRuns; ++i)
      if (run_len[i] > 0)
        slice_run(acc, smem4 + (run_row[i] + r0) * stride + tx, stride, run_len[i]);
    if (k < reps) __syncthreads();  // every thread is done with the tile
  }
  int* const ob = out + (size_t)blockIdx.y * R * W + col0;
#pragma unroll
  for (int g = 0; g < kSliceG; ++g) {
    const int r = r0 + g;
    if (r >= R) break;
    if (vec) {
      if (c < cols) *reinterpret_cast<int4*>(ob + r * W + c) = acc[g];
    } else {
      const int a[4] = {acc[g].x, acc[g].y, acc[g].z, acc[g].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < cols) ob[r * W + c + u] = a[u];
    }
  }
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape its kernel's shared-memory tile cannot
// hold. The gather and the row slice take `floor_only`: then they launch
// probe_empty_kernel on the grid, block and shared memory they would use.

namespace {

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Launch `kernel`, or with floor_only the empty kernel, on the same grid,
// block and dynamic shared memory (opted in where it passes 48 KB).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool floor_only, dim3 grid, dim3 block, int smem, cudaStream_t stream,
           Args... args) {
  if (smem > kSmemDefault) {
    const cudaError_t err =
        floor_only ? cudaFuncSetAttribute(probe_empty_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                   : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (floor_only)
    probe_empty_kernel<<<grid, block, smem, stream>>>();
  else
    kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Rows a looped-probe block stages: enough for its threads at
// `items_per_row` work items a row and `per_thread` items a thread, halved
// while the grid would give an SM fewer than two blocks, and no more than
// its shared memory holds.
int loop_rows(int B, int H, int items_per_row, int per_thread, int pitch) {
  const int sms = sm_count();
  int rows = max(1, kLoopThreads * per_thread / items_per_row);
  while (rows > 1 && (int64_t)B * ((H + rows - 1) / rows) < 2 * sms) rows >>= 1;
  return min(rows, kLoopSmemBytes / (pitch * 4));
}

}  // namespace

extern "C" int metro_probe_gather(const void* x, const void* idx, void* out, int B, int H, int W,
                                  int axis, int floor_only, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  if ((axis != 0 && axis != 1) || B > 65535 || (int64_t)H * W >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(x) && aligned16(idx) && aligned16(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const int* xi = (const int*)x;
  const int* ii = (const int*)idx;
  int* oi = (int*)out;
  if (axis == 0) {
    // the strip's H rows of 128 bytes
    if ((int64_t)H * kGatherStrip * 4 > kSmemMax) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + kGatherStrip - 1) / kGatherStrip, B);
    const int smem = H * kGatherStrip * 4;
    return vec ? launch(probe_gather_rows_kernel<true>, floor_only, grid, kGatherThreads, smem, s,
                        xi, ii, oi, H, W)
               : launch(probe_gather_rows_kernel<false>, floor_only, grid, kGatherThreads, smem,
                        s, xi, ii, oi, H, W);
  }
  // whole rows, about 16 KB a block, fewer while the grid would give an SM
  // fewer than two blocks
  if ((int64_t)W * 4 > kSmemMax) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  int rows = min(H, max(1, 4096 / W));
  while (rows > 1 && (int64_t)B * ((H + rows - 1) / rows) < 2 * sms) rows >>= 1;
  const dim3 grid((H + rows - 1) / rows, B);
  const int smem = rows * W * 4;
  return vec ? launch(probe_gather_cols_kernel<true>, floor_only, grid, kGatherThreads, smem, s,
                      xi, ii, oi, H, W, rows)
             : launch(probe_gather_cols_kernel<false>, floor_only, grid, kGatherThreads, smem, s,
                      xi, ii, oi, H, W, rows);
}

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
                                    int W, int R, int reps, int floor_only, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (H > kSliceMaxH || R < 1 || R >= H || W < 1 || reps < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int ygroups = (R + kSliceG - 1) / kSliceG;  // threads down the output rows
  const int rpad = kSliceG * ygroups;
  // column groups a block: all of a row's, at most what the block's threads
  // allow, halved while the grid would give an SM fewer than two blocks
  const int groups = (W + 3) / 4;
  int quads = min(groups, max(1, kSliceMaxThreads / ygroups));
  const int sms = sm_count();
  while (quads > 1 && (int64_t)B * ((groups + quads - 1) / quads) < 2 * sms)
    quads = (quads + 1) / 2;
  const int pitch = 4 * quads + 4;  // words a tile row: 4 more than the strip
  // up to kSliceRuns runs at once, and always one
  const int longest = min(reps, H - R);
  const int tile_rows = min(longest + kSliceRuns * (rpad - 1), kSmemMax / (pitch * 4));
  if (tile_rows < longest + rpad - 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((groups + quads - 1) / quads, B), block(quads, ygroups);
  return launch(probe_dynslice_kernel, floor_only, grid, block, tile_rows * pitch * 4,
                (cudaStream_t)stream, (const int*)x, (const int*)start, (int*)out, H, W, R, reps,
                tile_rows, (int)(W % 4 == 0 && aligned16(x) && aligned16(out)));
}
