// QK1: k x k int8 convolution as an implicit GEMM, int8 x int8 -> exact
// int32 on the tensor cores, with its epilogue fused:
//   acc      int32 out;
//   requant  int8 out, clip(round(relu?(acc * m[c] + b[c])))  (a junction);
//   dequant  (acc * s[c]).to(T) + bias[c].to(T), T float32 or bf16.
//
// Replaces no TPU kernel: the JAX package leaves these integer sums to XLA,
// its int8 convolution (metro_pose3d_tpu/models/quantize.py:191-195) and its
// 1x1 `dot_general` (:185-189), and lets XLA fuse the junction (:170-176)
// and the dequant (:199-202) into their epilogues. PyTorch has no int8
// convolution on CUDA, so this kernel computes them, the 1x1 convs included.
//
// GEMM view: x NHWC int8 [B,H,W,C], weights OHWI int8 [N,KH,KW,C],
// M = B*OH*OW output pixels, N = Cout, K = KH*KW*C taps in (ky, kx, ci)
// order, the order of an input pixel's channels in memory and of a weight
// row. A[m][k] is the input at (oy*stride - pad_top + ky*dil, ox*stride -
// pad_left + kx*dil, ci), 0 outside the image: any kernel size, stride,
// dilation and uneven pads (XLA SAME). Output NHWC: row m, column n at
// m*N + n. Sums are exact: |acc| <= 127^2 * K < 2^31 for K < 133,000.
//
// What bounds it on the card (R50 v2 @ 256, backbone batch 128, PERF.md):
// the long-K 3x3 convs (3x3/1 at 128 and 256 wide, the dilated 512) are
// bound by int8 operations, 0.018-0.072 ms each at 2.14 P op/s; the 64-wide
// 3x3 convs and every 1x1 conv by bytes, 0.006-0.09 ms each at 3.35 TB/s
// once the epilogue keeps the int32 sums out of device memory.
//
// The first design, the yardstick this one replaced: one block of 4 warps
// a 128 x 64 tile, `mma.sync.m16n8k32` from 32-bit shared loads, per-thread
// 16-byte `cp.async` three stages deep, scattered 1-2-byte stores from the
// registers: 2.89 ms for the 16 3x3 convs of a forward at B = 128 (15% of
// their 0.424 ms operations bound, 1.9x cuBLASLt's `_int_mm` on the same
// sums; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 17). The 1x1
// convs then went to `_int_mm`, whose int32 sums QK2 read back.
//
// Design of the `wgmma` variant (C % 16 == 0, 16-byte aligned pointers):
//  - Tensor cores: `wgmma.mma_async.m64nNk32.s32.s8.s8`, A and B K-major in
//    shared memory through matrix descriptors, 128B swizzle for a K chunk of
//    128 channels (C % 128 == 0), else 64B swizzle for a chunk of 64.
//  - Tiles: 128 output pixels x BN channels, two consumer warpgroups of 64
//    rows; BN = 64, 128 or 256 from N (ops/int8.py::qk1_plan). The 128
//    pixels are a rectangle of tile_h x tile_w pixels of one image
//    (tile_w = OW rounded up to a power of two, at most 128), so that one
//    TMA box holds a tap's inputs for the whole tile.
//  - Loads: TMA, one producer thread, into a ring of 2-8 stages (4 at
//    BN = 256) with full/empty `mbarrier`s; `setmaxnreg` gives the
//    consumers 232 registers and the producer warpgroup 40.
//      A: a tiled 4-D map over x [B,H,W,C]; the box of a (tap, chunk) starts
//         at (oy0*stride - pad_top + ky*dil, ox0*stride - pad_left + kx*dil),
//         with the conv's stride as the traversal stride; pixels outside the
//         image, and channels past C, arrive as zeros. Deviation from TMA's
//         im2col mode: tiled boxes take uneven pads as they are (a negative
//         corner) and every path shape tiles into 128-pixel rectangles, so
//         every shape, 1x1 and 3x3, takes this one loader.
//      B: a tiled 3-D map over the weights [N, taps, C]; channels past C
//         arrive as zeros, so a chunk never spans two taps. It is encoded
//         once per (pointer, shape) and cached on the host.
//  - Persistent blocks, one a SM, walk the tiles (n fastest, so the blocks
//    that share an A tile run side by side); the producer runs ahead into
//    the next tile while the consumers finish one, so the loads of the
//    short-K 1x1 convs stream. Each consumer keeps one `wgmma` group in
//    flight and frees a stage when the group that read it completes.
//  - Epilogue: from the accumulator registers, the int8_epilogue.cuh steps
//    (built with -fmad=false), 64 columns at a time, two neighbouring
//    columns a store, staged through a padded shared buffer of the
//    consumer's own and stored as 16-byte rows at offsets computed once a
//    tile (element stores where N * size % 16 != 0, e.g. N = 70); ragged M
//    and N are masked. A tile's epilogue runs while its SM's tensor cores
//    idle, and it bounds the short-K 1x1 convs: 8 consumer warps an SM
//    run it with little to hide latency. It was bound by conversions (16
//    a clock an SM): the requant's round and float-to-int are one add read
//    from the bits (clip_round), the int-to-float of |acc| <= 2^22 (K <=
//    256) two adds, a bf16 pair one conversion; each chunk's scales load
//    ahead of the chunk before it.
// Waves at B = 128 on 132 SMs (tiles / 132): 3x3/1 64 at 64^2: 4096 tiles
// of 128 x 64 (31.0); 3x3/2 64: 1024 (7.8); 3x3/1 128 at 32^2: 1024 of
// 128 x 128 (7.8); 3x3/2 128: 256 (1.9); 3x3/1 256 at 16^2: 256 of 128 x 256
// (1.9); dilated 512: 512 (3.9); the 1x1 convs 256 (at 16^2, N = 256) to
// 4096 (at 64^2) tiles, 1.9-31.0 waves.
//
// Scalar variant (any C, e.g. the 7x7 stem's C = 3, under quantize_extras
// "stem" only; the first design's byte-load variant): a block of 4 warps a 128 x 64 tile,
// each warp 64 x 32 with `mma.sync.m16n8k32.s8` from shared rows padded to
// 80 bytes, byte loads, one stage, stores from the registers.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "int8_epilogue.cuh"

namespace {

using namespace int8q;

enum Epilogue { kAcc = 0, kRequant = 1, kDequant = 2 };
enum Variant { kScalar = 0, kWgmma = 1 };

// ---- PTX wrappers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// about 10 s (2^34 clocks) traps, so that a pipeline fault fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a barrier of the 128 threads of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N, s32, registers) (+)= A (64 x 32, s8, descriptor) * B (N x 32, s8,
// descriptor)^T; `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (BN == 64) wgmma_s8_n64(d, desc_a, desc_b, accumulate);
  if constexpr (BN == 128) wgmma_s8_n128(d, desc_a, desc_b, accumulate);
  if constexpr (BN == 256) wgmma_s8_n256(d, desc_a, desc_b, accumulate);
}

// ---- end PTX wrappers ----

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  void* out;
  const float* scale;
  const float* bias;
  int H, W, C, OH, OW, N, KW, stride, dil, pad_top, pad_left, relu;
  int M, K;
};

// ---- scalar variant ----

constexpr int kBM = 128, kBN = 64, kBK = 64;  // block tile
constexpr int kLds = kBK + 16;                // bytes a shared row (padded)
constexpr int kThreads = 128;
constexpr int kRowInvalid = -(1 << 28);  // iy0 of a row past M: every tap outside

template <int EPI, typename OutT>
__global__ void __launch_bounds__(kThreads) int8_conv_scalar_kernel(ConvArgs p, int n_tiles) {
  __shared__ __align__(16) int8_t sa[kBM * kLds];
  __shared__ __align__(16) int8_t sb[kBN * kLds];
  __shared__ int s_iy0[kBM], s_ix0[kBM];
  __shared__ long long s_base[kBM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, each 64 x 32
  const int m0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * kBN;
  const int ohw = p.OH * p.OW;

  {  // the block's output rows: image, top-left input tap
    const int m = m0 + tid;
    if (m < p.M) {
      const int b = m / ohw, rem = m - b * ohw, oy = rem / p.OW, ox = rem - oy * p.OW;
      s_iy0[tid] = oy * p.stride - p.pad_top;
      s_ix0[tid] = ox * p.stride - p.pad_left;
      s_base[tid] = (long long)b * p.H * p.W * p.C;
    } else {
      s_iy0[tid] = kRowInvalid;
      s_ix0[tid] = 0;
      s_base[tid] = 0;
    }
  }

  const int kt_count = (p.K + kBK - 1) / kBK;
  auto load_scalar = [&](int kt) {
    // thread: column kk of the tile, A rows tid / 64 + 2 j, B rows tid / 64 + 2 j
    const int kk = tid & (kBK - 1), rs = tid >> 6;
    const int k = kt * kBK + kk;
    const bool kin = k < p.K;
    int dy = 0, dx = 0, ci = 0;
    if (kin) {
      const int tap = k / p.C;
      ci = k - tap * p.C;
      const int ky = tap / p.KW;
      dy = ky * p.dil;
      dx = (tap - ky * p.KW) * p.dil;
    }
    for (int r = rs; r < kBM; r += 2) {
      const int iy = s_iy0[r] + dy, ix = s_ix0[r] + dx;
      const bool ok = kin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      sa[r * kLds + kk] = ok ? p.x[s_base[r] + ((long long)iy * p.W + ix) * p.C + ci] : 0;
    }
    for (int r = rs; r < kBN; r += 2) {
      const int n = n0 + r;
      sb[r * kLds + kk] = kin && n < p.N ? p.w[(long long)n * p.K + k] : 0;
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0;

  auto ld_s32 = [](const int8_t* q) { return *reinterpret_cast<const int*>(q); };
  for (int kt = 0; kt < kt_count; ++kt) {
    __syncthreads();
    load_scalar(kt);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      int a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* q = sa + (wm * 64 + mi * 16 + g) * kLds + ks + t4 * 4;
        a[mi][0] = ld_s32(q);
        a[mi][1] = ld_s32(q + 8 * kLds);
        a[mi][2] = ld_s32(q + 16);
        a[mi][3] = ld_s32(q + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* q = sb + (wn * 32 + ni * 8 + g) * kLds + ks + t4 * 4;
        b[ni][0] = ld_s32(q);
        b[ni][1] = ld_s32(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // epilogue, from the registers: acc[mi][ni][h] is output row
  // m0 + 64 wm + 16 mi + g + 8 (h / 2), column n0 + 32 wn + 8 ni + 2 t4 + h % 2
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * t4 + hc;
      if (n >= p.N) continue;
      const float sc = EPI == kAcc ? 0.0f : p.scale[n];
      const float bi = EPI == kRequant ? p.bias[n] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = m0 + wm * 64 + mi * 16 + g + 8 * hr;
          if (m >= p.M) continue;
          const int v = acc[mi][ni][2 * hr + hc];
          OutT* o = static_cast<OutT*>(p.out) + (long long)m * p.N + n;
          if constexpr (EPI == kAcc) {
            *o = v;
          } else if constexpr (EPI == kRequant) {
            *o = requant(v, sc, bi, p.relu != 0);
          } else {
            *o = Dequant<OutT>::apply(v, sc, p.bias, n);
          }
        }
      }
    }
  }
}

template <int EPI, typename OutT>
cudaError_t launch_scalar_as(const ConvArgs& a, cudaStream_t s) {
  const long long m_tiles = (a.M + kBM - 1) / kBM, n_tiles = (a.N + kBN - 1) / kBN;
  if (m_tiles * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the n tiles of one m tile run side by side and share its A rows in L2
  int8_conv_scalar_kernel<EPI, OutT>
      <<<(unsigned)(m_tiles * n_tiles), kThreads, 0, s>>>(a, (int)n_tiles);
  return cudaGetLastError();
}

cudaError_t launch_scalar(const ConvArgs& a, int epi, int out_dtype, cudaStream_t s) {
  if (epi == kAcc && out_dtype == kI32) return launch_scalar_as<kAcc, int>(a, s);
  if (epi == kRequant && out_dtype == kI8) return launch_scalar_as<kRequant, int8_t>(a, s);
  if (epi == kDequant && out_dtype == kF32) return launch_scalar_as<kDequant, float>(a, s);
  if (epi == kDequant && out_dtype == kBF16)
    return launch_scalar_as<kDequant, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

// ---- end scalar variant ----

// ---- wgmma variant ----

constexpr int kTileM = 128;                // output pixels a tile: two warpgroups of 64
constexpr int kWgThreads = 384;            // warpgroup 0 loads, 1 and 2 compute
constexpr int kMaxStages = 8;
constexpr int kEpiCols = 64;               // columns a consumer stages at a time
constexpr int kStagedRowMax = kEpiCols * 4 + 16;  // bytes a staged row (4-byte out, padded)
constexpr int kStagingBytes = 2 * 64 * kStagedRowMax;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;
constexpr int kSmemMax = 232448;           // a block's shared memory on sm_90

struct WgArgs {
  void* out;
  const float* scale;
  const float* bias;
  int N, OH, OW, stride, dil, pad_top, pad_left, KW;
  int taps, c_chunks;                      // K = taps x c_chunks chunks of BK channels
  int tile_w_log2, tiles_w, tiles_h, n_tiles_n, n_tiles, stages;
  int epi, out_dtype, relu;
  int small_acc;  // K <= 256: |acc| <= 128^2 K <= 2^22, converted by small_acc_to_float
};

struct Tile {
  int b, oy0, ox0, nt;  // image, top-left output pixel, n tile
};

// tile t: n tiles fastest, then the rectangles of a row, the rows, the images
__device__ __forceinline__ Tile tile_at(int t, const WgArgs& p) {
  Tile c;
  c.nt = t % p.n_tiles_n;
  const int mt = t / p.n_tiles_n;
  const int tw = mt % p.tiles_w, rest = mt / p.tiles_w;
  c.ox0 = tw << p.tile_w_log2;
  c.oy0 = (rest % p.tiles_h) * (kTileM >> p.tile_w_log2);
  c.b = rest / p.tiles_h;
  return c;
}

// the output row (pixel index m) of tile row r, or -1 outside the output
__device__ __forceinline__ long long row_of(const Tile& c, int r, const WgArgs& p) {
  const int oy = c.oy0 + (r >> p.tile_w_log2);
  const int ox = c.ox0 + (r & ((1 << p.tile_w_log2) - 1));
  if (oy >= p.OH || ox >= p.OW) return -1;
  return ((long long)c.b * p.OH + oy) * p.OW + ox;
}

// K-major operand, rows of `row_bytes` (64 or 128) with the matching swizzle,
// 8-row groups 8 * row_bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : 2;  // 128B or 64B swizzle
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

// the epilogue of two neighbouring columns of one row, written to `dst` as
// one store: int8_epilogue.cuh's steps from acc as float32, converted by
// two adds where |acc| <= 2^22 (SMALL), else by I2F
template <int EPI, typename OutT, bool SMALL>
__device__ __forceinline__ void epi_pair(uint8_t* dst, int v0, int v1, const WgArgs& p, float s0,
                                         float s1, float b0, float b1) {
  if constexpr (EPI == kAcc) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else {
    const float f0 = SMALL ? small_acc_to_float(v0) : __int2float_rn(v0);
    const float f1 = SMALL ? small_acc_to_float(v1) : __int2float_rn(v1);
    if constexpr (EPI == kRequant) {
      const uint8_t q0 = (uint8_t)requant_f(f0, s0, b0, p.relu != 0);
      const uint8_t q1 = (uint8_t)requant_f(f1, s1, b1, p.relu != 0);
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(q0 | (q1 << 8));
    } else if constexpr (sizeof(OutT) == 4) {  // Dequant<float>'s steps
      float y0 = __fmul_rn(f0, s0), y1 = __fmul_rn(f1, s1);
      if (p.bias) {
        y0 = __fadd_rn(y0, b0);
        y1 = __fadd_rn(y1, b1);
      }
      *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          dequant_bf16_pair(f0, f1, s0, s1, p.bias != nullptr, b0, b1);
    }
  }
}

// the scale and bias (rounded to bf16 for a bf16 dequant) of this thread's
// 16 columns of the chunk at nb: columns nb + 8 (i / 2) + 2 (lane % 4) +
// i % 2 (past N: channel N - 1's, never stored)
template <int EPI, typename OutT>
__device__ __forceinline__ void load_columns(const WgArgs& p, int nb, int lane, float (&sc)[16],
                                             float (&bi)[16]) {
  const int n0 = nb + 2 * (lane & 3);
  const bool whole = nb + kEpiCols <= p.N;  // the same for the whole warpgroup
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int off = whole ? 8 * (i >> 1) + (i & 1) : min(n0 + 8 * (i >> 1) + (i & 1), p.N - 1) - n0;
    sc[i] = EPI == kAcc ? 0.0f : __ldg(p.scale + n0 + off);
    bi[i] = 0.0f;
    if (EPI == kRequant || (EPI == kDequant && p.bias)) {
      bi[i] = __ldg(p.bias + n0 + off);
      if (EPI == kDequant && sizeof(OutT) == 2) bi[i] = __bfloat162float(__float2bfloat16_rn(bi[i]));
    }
  }
}

// one consumer's 64 rows of the tile: the epilogue from the registers, 64
// columns at a time through its staging buffer, then 16-byte row stores
// (thread t stores bytes 16 (t % V) of rows t / V + (128 / V) i, V the
// vectors a row; their output offsets are computed once a tile); the next
// chunk's scale and bias load before this chunk's stores
template <int BN, int EPI, typename OutT, bool SMALL>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], const WgArgs& p,
                                           const Tile& c, int n0, uint8_t* stg, int cw,
                                           int ltid) {
  constexpr int ES = sizeof(OutT);
  constexpr int kRow = kEpiCols * ES + 16;
  constexpr int kVecs = kEpiCols * ES / 16;  // 16-byte vectors a staged row
  constexpr int kRowsPerPass = 128 / kVecs;
  const int warp = ltid >> 5, lane = ltid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8
  const bool vec = (p.N * ES) % 16 == 0;
  const int c16 = ltid % kVecs, rs = ltid / kVecs;
  long long row_off[kVecs / 2];  // byte offset of this thread's stored rows, -1 outside
#pragma unroll
  for (int i = 0; i < kVecs / 2; ++i) {
    const long long m = row_of(c, cw * 64 + rs + kRowsPerPass * i, p);
    row_off[i] = m < 0 ? -1 : (m * p.N + c16 * (16 / ES)) * ES;
  }
  uint8_t* out = static_cast<uint8_t*>(p.out);
  float sc[16], bi[16];
  load_columns<EPI, OutT>(p, n0, lane, sc, bi);
#pragma unroll
  for (int j = 0; j < BN / kEpiCols; ++j) {
    const int nb = n0 + j * kEpiCols;
    if (nb >= p.N) break;  // the same for the whole warpgroup
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = 8 * q + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi_pair<EPI, OutT, SMALL>(stg + (r0 + 8 * h) * kRow + col * ES,
                                   acc[32 * j + 4 * q + 2 * h], acc[32 * j + 4 * q + 2 * h + 1],
                                   p, sc[2 * q], sc[2 * q + 1], bi[2 * q], bi[2 * q + 1]);
    }
    if (j + 1 < BN / kEpiCols && nb + kEpiCols < p.N)
      load_columns<EPI, OutT>(p, nb + kEpiCols, lane, sc, bi);
    warpgroup_bar(1 + cw);
    if (vec) {
      const bool col_in = nb + c16 * (16 / ES) < p.N;
      uint8_t* base = out + (long long)nb * ES;
#pragma unroll
      for (int i = 0; i < kVecs / 2; ++i)
        if (row_off[i] >= 0 && col_in)
          *reinterpret_cast<uint4*>(base + row_off[i]) =
              *reinterpret_cast<const uint4*>(stg + (rs + kRowsPerPass * i) * kRow + c16 * 16);
    } else {
      OutT* o = static_cast<OutT*>(p.out);
      for (int e = ltid; e < 64 * kEpiCols; e += 128) {
        const int r = e / kEpiCols, cc = e % kEpiCols;
        const long long m = row_of(c, cw * 64 + r, p);
        if (m >= 0 && nb + cc < p.N)
          o[m * p.N + nb + cc] = *reinterpret_cast<const OutT*>(stg + r * kRow + cc * ES);
      }
    }
    warpgroup_bar(1 + cw);  // the staging buffer is read before it is written again
  }
}

template <int BN, int EPI, typename OutT>
__device__ __forceinline__ void store_tile_as(const int (&acc)[BN / 2], const WgArgs& p,
                                              const Tile& c, int n0, uint8_t* stg, int cw,
                                              int ltid) {
  if (p.small_acc)
    store_tile<BN, EPI, OutT, true>(acc, p, c, n0, stg, cw, ltid);
  else
    store_tile<BN, EPI, OutT, false>(acc, p, c, n0, stg, cw, ltid);
}

template <int BN, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w, const WgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int a_bytes = kTileM * BK, stage_bytes = a_bytes + BN * BK;
  uint8_t* ring = smem;
  uint8_t* staging = smem + p.stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStagingBytes);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int kblocks = p.taps * p.c_chunks;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzle patterns need 1024-byte stages
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the bytes of the stage
      mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread walks the block's tiles and their (tap, chunk)s
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const Tile c = tile_at(t, p);
        const int iy0 = c.oy0 * p.stride - p.pad_top, ix0 = c.ox0 * p.stride - p.pad_left;
        for (int tap = 0; tap < p.taps; ++tap) {
          const int ky = tap / p.KW, kx = tap - ky * p.KW;
          for (int cc = 0; cc < p.c_chunks; ++cc) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* a = ring + stage * stage_bytes;
            mbar_expect_tx(&full[stage], stage_bytes);
            tma_load_4d(a, &map_x, &full[stage], cc * BK, ix0 + kx * p.dil, iy0 + ky * p.dil,
                        c.b);
            tma_load_3d(a + a_bytes, &map_w, &full[stage], cc * BK, tap, c.nt * BN);
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes rows 0-63 of a tile, warpgroup 2 rows 64-127
  setmaxnreg_inc<232>();
  const int cw = wg - 1, ltid = tid & 127;
  uint8_t* stg = staging + cw * 64 * kStagedRowMax;
  int acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const Tile c = tile_at(t, p);
    int prev = -1;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(ring + stage * stage_bytes) + cw * 64 * BK;
      const uint32_t b = smem_u32(ring + stage * stage_bytes + a_bytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_s8<BN>(acc, kmajor_desc(a + 32 * ks, BK), kmajor_desc(b + 32 * ks, BK),
                     (kb | ks) != 0);
      wgmma_commit();
      // the group before this one has read its stage: free it
      wgmma_wait<1>();
      if (prev >= 0 && ltid == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (ltid == 0) mbar_arrive(&empty[prev]);
    const int n0 = c.nt * BN;
    if (p.epi == kAcc) {
      store_tile<BN, kAcc, int, false>(acc, p, c, n0, stg, cw, ltid);
    } else if (p.epi == kRequant) {
      store_tile_as<BN, kRequant, int8_t>(acc, p, c, n0, stg, cw, ltid);
    } else if (p.out_dtype == kF32) {
      store_tile_as<BN, kDequant, float>(acc, p, c, n0, stg, cw, ltid);
    } else {
      store_tile_as<BN, kDequant, __nv_bfloat16>(acc, p, c, n0, stg, cw, ltid);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return (EncodeTiled)f;
  }();
  return fn;
}

// an int8 tiled map: dims innermost first, byte strides of dims 1.., the box
bool encode(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, const cuuint32_t* elem_strides,
            int bk) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the weights' map [N, taps, C], encoded once per (pointer, shape, box): a
// map holds only the address and the shape, so it serves any tensor there
bool weight_map(CUtensorMap* map, const void* w, int C, int taps, int N, int bk, int bn) {
  struct Entry {
    const void* w;
    int C, taps, N, bk, bn;
    CUtensorMap map;
  };
  thread_local Entry cache[16];
  thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.w == w && e.C == C && e.taps == taps && e.N == N && e.bk == bk && e.bn == bn) {
      *map = e.map;
      return true;
    }
  }
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)taps, (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)C, (cuuint64_t)taps * C};
  const cuuint32_t box[3] = {(cuuint32_t)bk, 1, (cuuint32_t)bn};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (!encode(map, 3, w, dims, strides, box, ones, bk)) return false;
  Entry& e = cache[next];
  e = Entry{w, C, taps, N, bk, bn, *map};
  next = (next + 1) % 16;
  if (used < 16) ++used;
  return true;
}

// the current device's SM count, asked once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

template <int BN, int BK>
cudaError_t launch_wgmma_as(const CUtensorMap& mx, const CUtensorMap& mw, const WgArgs& a,
                            int smem, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_wgmma_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return attr;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  int8_conv_wgmma_kernel<BN, BK><<<grid, kWgThreads, smem, s>>>(mx, mw, a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma_bn(const CUtensorMap& mx, const CUtensorMap& mw, const WgArgs& a,
                            int bk, int smem, cudaStream_t s) {
  return bk == 128 ? launch_wgmma_as<BN, 128>(mx, mw, a, smem, s)
                   : launch_wgmma_as<BN, 64>(mx, mw, a, smem, s);
}

// ---- end wgmma variant ----

}  // namespace

// x: int8 NHWC [B,H,W,C]; w: int8 OHWI [N,KH,KW,C]; out: NHWC [B,OH,OW,N]
// of int32 (epi 0), int8 (epi 1) or float32 / bf16 (epi 2, out_dtype 0 /
// 1); scale, bias: float32 [N] (scale unused by epi 0, bias required by epi
// 1, optional, may be null, for epi 2). variant 0 (scalar) takes any C;
// variant 1 (wgmma) needs C % 16 == 0, x, w and out 16-byte aligned, and the
// plan (ops/int8.py::qk1_plan): bn 64 / 128 / 256, bk 64 / 128, stages
// 2-8, tile_w a power of two dividing 128, stride 1 or 2 (a TMA box spans
// at most 256 pixels a side). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int metro_int8_conv(const void* x, const void* w, void* out, const void* scale,
                               const void* bias, int B, int H, int W, int C, int OH, int OW,
                               int N, int KH, int KW, int stride, int dil, int pad_top,
                               int pad_left, int epi, int out_dtype, int relu, int variant,
                               int bn, int bk, int stages, int tile_w, void* stream) {
  const long long M = (long long)B * OH * OW, K = (long long)KH * KW * C;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (M > 0x7fffffffLL || K > 133000 || K == 0 || stride < 1 || dil < 1)
    return (int)cudaErrorInvalidValue;
  if ((epi != kAcc && !scale) || (epi == kRequant && !bias)) return (int)cudaErrorInvalidValue;
  const bool epi_ok = (epi == kAcc && out_dtype == kI32) || (epi == kRequant && out_dtype == kI8) ||
                      (epi == kDequant && (out_dtype == kF32 || out_dtype == kBF16));
  if (!epi_ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == kScalar) {
    const ConvArgs a{(const int8_t*)x, (const int8_t*)w, out, (const float*)scale,
                     (const float*)bias, H, W, C, OH, OW, N, KW, stride, dil, pad_top,
                     pad_left, relu, (int)M, (int)K};
    return (int)launch_scalar(a, epi, out_dtype, s);
  }
  if (variant != kWgmma) return (int)cudaErrorInvalidValue;
  const int tile_h = tile_w > 0 ? kTileM / tile_w : 0;
  int tw_log2 = 0;
  while (tw_log2 < 8 && (1 << tw_log2) < tile_w) ++tw_log2;
  const bool plan_ok = C % 16 == 0 && (bn == 64 || bn == 128 || bn == 256) &&
                       (bk == 64 || bk == 128) && stages >= 2 && stages <= kMaxStages &&
                       tile_w >= 1 && (1 << tw_log2) == tile_w && tile_w <= kTileM &&
                       stride <= 2;
  if (!plan_ok || ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = stages * (kTileM + bn) * bk + kStagingBytes + kBarrierBytes;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const long long tiles_w = (OW + tile_w - 1) / tile_w, tiles_h = (OH + tile_h - 1) / tile_h;
  const long long n_tiles_n = (N + bn - 1) / bn;
  const long long n_tiles = (long long)B * tiles_h * tiles_w * n_tiles_n;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  CUtensorMap mx, mw;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const cuuint32_t box[4] = {(cuuint32_t)bk, (cuuint32_t)(tile_w * stride),
                             (cuuint32_t)(tile_h * stride), 1};
  const cuuint32_t elem_strides[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  if (!encode(&mx, 4, x, dims, strides, box, elem_strides, bk)) return (int)cudaErrorInvalidValue;
  if (!weight_map(&mw, w, C, KH * KW, N, bk, bn)) return (int)cudaErrorInvalidValue;

  const int c_chunks = (C + bk - 1) / bk;
  const WgArgs a{out, (const float*)scale, (const float*)bias, N, OH, OW, stride, dil, pad_top,
                 pad_left, KW, KH * KW, c_chunks, tw_log2, (int)tiles_w, (int)tiles_h,
                 (int)n_tiles_n, (int)n_tiles, stages, epi, out_dtype, relu, K <= 256};
  if (bn == 64) return (int)launch_wgmma_bn<64>(mx, mw, a, bk, smem, s);
  if (bn == 128) return (int)launch_wgmma_bn<128>(mx, mw, a, bk, smem, s);
  return (int)launch_wgmma_bn<256>(mx, mw, a, bk, smem, s);
}
