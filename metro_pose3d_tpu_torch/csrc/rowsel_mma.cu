// One-hot row-select probe on the tensor cores:
//   out[b] = sum_{k<reps} roll(P[b], k, rows) @ S[b]
// P [R, 160] one-hot bf16, S [160, 128] bf16, out [R, 128] float32;
// roll(P, k)[r] = P[(r - k) mod R]. Every rep does its whole R x 160 x 128
// product: the probe measures repeated matrix products, as the TPU probe
// measures 64 `dot_general`s, so the sum of rolls is not hoisted out of the
// product and the one-hot is not turned into a gather.
//
// Replaces: scripts/exp_pallas_prims.py::build_rowsel (its pallas_call). No
// path of the system calls it; `metro_pose3d_tpu_torch/probes/prims.py` times it.
//
// What bounds it on the card: bf16 tensor-core operations, 2 * 160 per output
// element a rep (at B = 64, R = 64, 64 reps: 10.7 GFLOP, 0.0109 ms at
// 989 TFLOP/s). Bytes are small (P and S 3.9 MB, the output 2.1 MB).
//
// Design: one warpgroup (128 threads) a block takes 64 rows of one batch
// element and a share of its reps; grid (split, R / 64, B). Each rep is ten
// `wgmma.mma_async.m64n128k16.f32.bf16.bf16`:
//  - A from registers, loaded by `ldmatrix.x4` from P held in shared memory.
//    The roll lives in the row addresses: lane l of warp w reads row
//    (64 m + 16 w + l % 16 - k) mod R. P's rows are padded to 168 bf16
//    (336 bytes), so the eight rows of an 8x8 matrix fall in distinct banks.
//  - B (S, 40 KB) in shared memory, copied once a block by cp.async as it
//    lies in memory, n contiguous: 8x8 core matrices without swizzle in
//    the MN-major layout (wgmma's transposed B, for 16-bit types), element
//    (k, n) at byte (k / 8) * 2048 + (n / 8) * 128 + (k % 8) * 16 + (n % 8) * 2.
//  - Two sets of A fragments: the fragments of rep k + 1 load while the ten
//    products of rep k run (one commit group a rep, wait_group 1).
//  - The float32 accumulators live in registers across all of the block's
//    reps; the blocks of one element (split) then add their partial sums into
//    the zeroed output with float32 atomics. Every partial sum is an integer
//    below 2^24 (at most 64 * 255), so any order gives the same bits.
// At B = 64 the default split of 2 gives 128 blocks for 132 SMs. It measured
// about twice the bound (PERF.md): a block copies S and P into shared
// memory before its first product, and nothing overlaps that copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 160, kN = 128, kM = 64;  // depth, width, rows a warpgroup
constexpr int kKSteps = kK / 16;            // k16 steps of one product
constexpr int kPStride = kK + 8;            // bf16 a row of P in shared memory
constexpr int kSBO = 128;                   // bytes to the next 8 columns (n) of B
constexpr int kLBO = (kN / 8) * 128;        // bytes to the next 8 of depth (k) of B
constexpr int kSBytes = (kK / 8) * kLBO;    // 40 KB
constexpr int kThreads = 128;
constexpr int kMaxR = 512;  // P's rows and S fit in shared memory (212 KB)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// matrix descriptor: start address, LBO and SBO in 16-byte units, no swizzle
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d[64] += A (registers, 64x16 over the warpgroup) @ B (descriptor, 16x128)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"  // B transposed: MN-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the fragments of rep k: lane rows (row - k) mod R, the roll in the address
__device__ __forceinline__ void load_a(uint32_t (&a)[kKSteps][4], uint32_t p_base, int row,
                                       int k, int R) {
  int src = (row - k) % R;
  if (src < 0) src += R;
  const uint32_t addr = p_base + src * (kPStride * 2);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) ldmatrix_x4(a[ks], addr + ks * 32);
}

// one rep: ten k16 products into acc, committed as one group; then wait until
// at most this group is pending, so the group before it has read its fragments
__device__ __forceinline__ void mma_group(float (&acc)[64], const uint32_t (&a)[kKSteps][4],
                                          uint64_t desc0) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    wgmma_m64n128k16(acc, a[ks], desc0 + (uint64_t)((2 * ks * kLBO) >> 4));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    rowsel_wgmma_kernel(const uint16_t* __restrict__ p, const uint16_t* __restrict__ s,
                        float* __restrict__ out, int R, int reps, int split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int b = blockIdx.z, mt = blockIdx.y, sp = blockIdx.x;
  const int k_begin = (int)((int64_t)sp * reps / split);
  const int k_end = (int)((int64_t)(sp + 1) * reps / split);
  if (k_begin == k_end) return;  // more blocks than reps: nothing to add
  uint8_t* s_sm = smem;
  uint16_t* p_sm = reinterpret_cast<uint16_t*>(smem + kSBytes);
  const int tid = threadIdx.x;

  // S[b] [160][128] and P[b] [R][160] into shared memory by cp.async, 16
  // bytes at a time and as they are: a row of 8 n of S is a row of a core
  // matrix (MN-major B), a row of P goes to a padded row
  const char* sb = reinterpret_cast<const char*>(s + (int64_t)b * kK * kN);
  for (int c = tid; c < kK * (kN / 8); c += kThreads) {
    const int k = c / (kN / 8), nb = c % (kN / 8);
    cp_async16(smem_addr(s_sm + (k / 8) * kLBO + nb * kSBO + (k % 8) * 16),
               sb + (k * kN + nb * 8) * 2);
  }
  const char* pb = reinterpret_cast<const char*>(p + (int64_t)b * R * kK);
  for (int e = tid; e < R * (kK / 8); e += kThreads)
    cp_async16(smem_addr(p_sm + (e / (kK / 8)) * kPStride + (e % (kK / 8)) * 8), pb + e * 16);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the copies, made visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int row = mt * kM + warp * 16 + (lane & 15);  // the A row this lane addresses
  const uint32_t p_base = smem_addr(p_sm) + (lane >> 4) * 16;  // k 0-7 or 8-15 of a k-step
  const uint64_t desc0 = b_descriptor(smem_addr(s_sm));
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // two sets of A fragments: while the products of rep k run, the fragments of
  // rep k + 1 load into the other set; a set is reloaded only after the group
  // that read it has completed (wait_group 1 after the next group's commit)
  uint32_t a0[kKSteps][4], a1[kKSteps][4];
  load_a(a0, p_base, row, k_begin, R);
  for (int k = k_begin; k < k_end; k += 2) {
    mma_group(acc, a0, desc0);
    if (k + 1 < k_end) load_a(a1, p_base, row, k + 1, R);
    if (k + 1 >= k_end) break;
    mma_group(acc, a1, desc0);
    if (k + 2 < k_end) load_a(a0, p_base, row, k + 2, R);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator layout: d[4j + h] at row 16 w + lane / 4 + 8 (h / 2),
  // column 8 j + 2 (lane % 4) + h % 2
  float* ob = out + ((int64_t)b * R + mt * kM + warp * 16 + lane / 4) * kN + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 4; ++h) atomicAdd(ob + (h / 2) * 8 * kN + 8 * j + (h % 2), acc[4 * j + h]);
  }
}

}  // namespace

// p: bf16 [B, R, 160]; s: bf16 [B, 160, 128]; out: float32 [B, R, 128],
// zeroed by the caller; R a multiple of 64, at most 512; `split` blocks share
// the reps of each 64 rows. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int metro_probe_rowsel(const void* p, const void* s, void* out, int B, int R, int K,
                                  int N, int reps, int split, void* stream) {
  if (B == 0 || reps == 0) return (int)cudaSuccess;
  if (K != kK || N != kN || R < kM || R % kM != 0 || R > kMaxR || split < 1 || reps < 0)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once, for the largest R
      rowsel_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSBytes + kMaxR * kPStride * 2);
  if (attr != cudaSuccess) return (int)attr;
  const int smem = kSBytes + R * kPStride * 2;
  const dim3 grid(split, R / kM, B);
  rowsel_wgmma_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)p, (const uint16_t*)s, (float*)out, R, reps, split);
  return (int)cudaGetLastError();
}
