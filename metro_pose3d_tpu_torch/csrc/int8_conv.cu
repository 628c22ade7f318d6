// QK1: k x k int8 convolution as an implicit GEMM, int8 x int8 -> exact
// int32 on the tensor cores, with its epilogue fused:
//   acc      int32 out;
//   requant  int8 out, clip(round(relu?(acc * m[c] + b[c])))  (a junction);
//   dequant  (acc * s[c]).to(T) + bias[c].to(T), T float32 or bf16.
//
// Not a TPU kernel: the JAX package leaves these integer sums to XLA's int8
// convolution (metro_pose3d_tpu/models/quantize.py, QuantConv's
// `lax.conv_general_dilated(..., preferred_element_type=int32)`), and lets
// XLA fuse the junction into its epilogue. PyTorch has no int8 convolution
// on CUDA, so this kernel computes them.
//
// GEMM view: x NHWC int8 [B,H,W,C], weights OHWI int8 [N,KH,KW,C],
// M = B*OH*OW output pixels, N = Cout, K = KH*KW*C taps in (ky, kx, ci)
// order, the order of an input pixel's channels in memory and of a weight
// row. A[m][k] is the input at (oy*stride - pad_top + ky*dil, ox*stride -
// pad_left + kx*dil, ci), 0 outside the image: any kernel size, stride,
// dilation and uneven pads (XLA SAME) work. Output NHWC: row m, column n at
// m*N + n. Sums are exact: |acc| <= 127^2 * K < 2^31 for K < 133,000.
//
// What bounds it on the card: at the main path's shapes (R50 v2 @ 256,
// batch 128) the 3x3 convs do 19-77 G multiply-adds each, 0.018-0.072 ms at
// the card's dense int8 rate, against 0.01-0.02 ms for their bytes, so
// operations bound them, barely; the first design below is far from both.
//
// Design (simple first): a block of 4 warps computes a 128 x 64 output tile,
// each warp 64 x 32 with `mma.sync.m16n8k32.s8` (16 products a k32 step);
// K in steps of 64. Vector variant (C % 16 == 0, 16-byte aligned
// pointers): each thread copies 16-byte runs of one tap's channels with
// `cp.async` (a pad tap copies 0 bytes and zero-fills), three stages in
// flight. Scalar variant (any C, e.g. the 7x7 stem's C = 3): byte loads,
// one stage. Shared rows are padded from 64 to 80 bytes, so the eight rows
// of a fragment load fall in distinct banks. The epilogue works from the
// accumulator registers and stores straight to global memory.
#include "int8_epilogue.cuh"

namespace {

using namespace int8q;

constexpr int kBM = 128, kBN = 64, kBK = 64;  // block tile
constexpr int kLds = kBK + 16;                // bytes a shared row (padded)
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kRowInvalid = -(1 << 28);  // iy0 of a row past M: every tap outside

enum Epilogue { kAcc = 0, kRequant = 1, kDequant = 2 };

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  void* out;
  const float* scale;
  const float* bias;
  int H, W, C, OH, OW, N, KW, stride, dil, pad_top, pad_left, relu;
  int M, K;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A * B for one 16 x 8 x 32 int8 tile: A row-major (a: rows g and
// g + 8, k 4t..4t+3 and 16 + 4t..), B column-major (b: k 4t.. and 16 + 4t..
// of column g), D rows g and g + 8, columns 2t and 2t + 1 (g = lane / 4,
// t = lane % 4)
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int ld_s32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

template <int VEC, int EPI, typename OutT>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(ConvArgs p, int n_tiles) {
  __shared__ __align__(16) int8_t sa[(VEC == 16 ? kStages : 1) * kBM * kLds];
  __shared__ __align__(16) int8_t sb[(VEC == 16 ? kStages : 1) * kBN * kLds];
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
  __syncthreads();

  const int kt_count = (p.K + kBK - 1) / kBK;
  // vector variant: this thread's k chunk and its four A rows, two B rows
  const int kc = tid & 3, r0 = tid >> 2;
  int iy0[4], ix0[4];
  long long base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    iy0[i] = s_iy0[r0 + 32 * i];
    ix0[i] = s_ix0[r0 + 32 * i];
    base[i] = s_base[r0 + 32 * i];
  }

  auto load_vec = [&](int stage, int kt) {
    const int k = kt * kBK + kc * 16;
    int dy = 0, dx = 0, ci = 0;
    const bool kin = k < p.K;
    if (kin) {
      const int tap = k / p.C;
      ci = k - tap * p.C;
      const int ky = tap / p.KW;
      dy = ky * p.dil;
      dx = (tap - ky * p.KW) * p.dil;
    }
    int8_t* a_dst = sa + stage * kBM * kLds + kc * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = iy0[i] + dy, ix = ix0[i] + dx;
      const bool ok = kin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int8_t* src = ok ? p.x + base[i] + ((long long)iy * p.W + ix) * p.C + ci : p.x;
      cp_async16(a_dst + (r0 + 32 * i) * kLds, src, ok ? 16 : 0);
    }
    int8_t* b_dst = sb + stage * kBN * kLds + kc * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + r0 + 32 * j;
      const bool ok = kin && n < p.N;
      const int8_t* src = ok ? p.w + (long long)n * p.K + k : p.w;
      cp_async16(b_dst + (r0 + 32 * j) * kLds, src, ok ? 16 : 0);
    }
  };

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

  auto compute = [&](int stage) {
    const int8_t* as = sa + stage * kBM * kLds;
    const int8_t* bs = sb + stage * kBN * kLds;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      int a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* q = as + (wm * 64 + mi * 16 + g) * kLds + ks + t4 * 4;
        a[mi][0] = ld_s32(q);
        a[mi][1] = ld_s32(q + 8 * kLds);
        a[mi][2] = ld_s32(q + 16);
        a[mi][3] = ld_s32(q + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* q = bs + (wn * 32 + ni * 8 + g) * kLds + ks + t4 * 4;
        b[ni][0] = ld_s32(q);
        b[ni][1] = ld_s32(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  };

  if constexpr (VEC == 16) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < kt_count) load_vec(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < kt_count; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
      const int next = kt + kStages - 1;
      if (next < kt_count) load_vec(next % kStages, next);
      cp_async_commit();
      compute(kt % kStages);
    }
  } else {
    for (int kt = 0; kt < kt_count; ++kt) {
      __syncthreads();
      load_scalar(kt);
      __syncthreads();
      compute(0);
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

template <int VEC, int EPI, typename OutT>
cudaError_t launch(const ConvArgs& a, cudaStream_t s) {
  const long long m_tiles = (a.M + kBM - 1) / kBM, n_tiles = (a.N + kBN - 1) / kBN;
  if (m_tiles * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the n tiles of one m tile run side by side and share its A rows in L2
  int8_conv_kernel<VEC, EPI, OutT>
      <<<(unsigned)(m_tiles * n_tiles), kThreads, 0, s>>>(a, (int)n_tiles);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const ConvArgs& a, int epi, int out_dtype, cudaStream_t s) {
  if (epi == kAcc && out_dtype == kI32) return launch<VEC, kAcc, int>(a, s);
  if (epi == kRequant && out_dtype == kI8) return launch<VEC, kRequant, int8_t>(a, s);
  if (epi == kDequant && out_dtype == kF32) return launch<VEC, kDequant, float>(a, s);
  if (epi == kDequant && out_dtype == kBF16) return launch<VEC, kDequant, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: int8 NHWC [B,H,W,C]; w: int8 OHWI [N,KH,KW,C] (KH = KW); out: NHWC
// [B,OH,OW,N] of int32 (epi 0), int8 (epi 1) or float32 / bf16 (epi 2,
// out_dtype 0 / 1); scale, bias: float32 [N] (scale unused by epi 0, bias
// required by epi 1, optional, may be null, for epi 2). vec 16 needs C % 16
// == 0 and x, w 16-byte aligned; vec 1 takes any C. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what it
// does not take.
extern "C" int metro_int8_conv(const void* x, const void* w, void* out, const void* scale,
                               const void* bias, int B, int H, int W, int C, int OH, int OW,
                               int N, int KH, int KW, int stride, int dil, int pad_top,
                               int pad_left, int epi, int out_dtype, int relu, int vec,
                               void* stream) {
  const long long M = (long long)B * OH * OW, K = (long long)KH * KW * C;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (M > 0x7fffffffLL || K > 133000 || K == 0 || stride < 1 || dil < 1)
    return (int)cudaErrorInvalidValue;
  if ((epi != kAcc && !scale) || (epi == kRequant && !bias)) return (int)cudaErrorInvalidValue;
  const ConvArgs a{(const int8_t*)x, (const int8_t*)w, out, (const float*)scale,
                   (const float*)bias, H, W, C, OH, OW, N, KW, stride, dil, pad_top,
                   pad_left, relu, (int)M, (int)K};
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 16) {
    if (C % 16 != 0 || ((uintptr_t)x | (uintptr_t)w) % 16 != 0) return (int)cudaErrorInvalidValue;
    return (int)dispatch<16>(a, epi, out_dtype, s);
  }
  if (vec == 1) return (int)dispatch<1>(a, epi, out_dtype, s);
  return (int)cudaErrorInvalidValue;
}
