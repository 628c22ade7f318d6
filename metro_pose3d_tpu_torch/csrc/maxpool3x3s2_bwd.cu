// Gradient of the 3x3 stride-2 max pool (the ResNet stem pool) in its three
// alignments: "SAME", torch and Keras (see maxpool3x3s2.cu).
//
// Replaces: the TPU has no Pallas backward. JAX training differentiates the
// shift-and-max chain of metro_pose3d_tpu/ops/pool_pallas.py
// (`stem_max_pool(mode, train=True)` -> `_maxpool_reference` :112,
// `_maxpool_reference_torch` :173, `_maxpool_reference_keras` :310,
// `_maxpool_reference_odd` :387), whose forward kernel `_maxpool_fwd_pallas`
// (`pallas_call` :90) is ported in maxpool3x3s2.cu.
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
// g * r_k * l_{k+1} * ... * l_8 (r_0 = 1): a product of 0, 1/2 and 1, exact
// in any order, so ties split exactly as the chain splits them. Each input
// element sums its up to four windows' shares in float32 in a fixed order
// (window row, then column) and is written once in x's dtype: deterministic,
// no atomics.
//
// What bounds it on the card: bytes, at [96,64,128,128] bf16 reading x
// (201 MB) and g (50 MB) and writing dx (201 MB) once: 0.135 ms at
// 3.35 TB/s. The first port took one thread per input element and channel
// and re-walked the whole chain of each of its (up to four) windows: 36
// scalar 2-byte loads of x and four of g for one 2-byte output, with int64
// index division. It ran at 3.5 ms, bound by load instructions through L1.
// With the loads vectorised, instruction issue is the limit: a chain link
// costs about ten float32 instructions a lane, so each window's chain has to
// be walked as few times, and in as few instructions, as possible.
//
// Design: a thread owns the "home" 2x2 blocks of a column of windows: home
// block (hy, hx) is padded rows 2hy, 2hy+1 and padded columns 2hx, 2hx+1,
// for one 16-byte channel vector (8 bf16 or 4 float32 channels). The
// windows that touch it are (hy-1, hx-1), (hy-1, hx), (hy, hx-1), (hy, hx):
// windows of row hy-1 reach it with their tap row 2 only. A thread takes R
// = 2 home rows hy0, hy0+1 and walks the window rows hy0-1..hy0+1 once
// each, two windows a row (columns hx-1 and hx, which share a tap column):
// it loads their 3x5 taps as vectors (`ld.global.nc`; the top row is the
// bottom row of the window row before, kept in registers), walks each
// window's chain once, gets all nine weights with one suffix product, and
// adds g * w (skipping w = 0) into float32 accumulators of the cells the
// taps land on: rows 0 and 1 into home row wr, row 2 into home row wr + 1,
// which is finished by the next window row. A window is walked three times
// for two home rows (by the threads of home columns hx and hx + 1, and
// again for the first row of a strip) instead of four times a home row, and
// every cell receives its windows' shares in the first port's order, so
// the float32 sums, and the bf16 results, are the first port's bit for bit.
// bf16 lanes walk their chains two at a time in packed bf16x2 arithmetic
// (compares, max, and the weights as bf16x2 products), which halves the
// instructions of the walk and is exact (see `Chain`). Longer strips re-walk
// less but leave fewer threads in flight: at the main-path shape two rows
// ran faster than one, four or eight on the H100 (PERF.md). The
// grid is (channel vector x home column, strip of R home rows, batch), with
// 32-bit index math within one image.
//
// The home grid is not OH x OW: it is ceil((H + pad_top) / 2) x
// ceil((W + pad_left) / 2). In the torch and Keras alignments with an even
// size, the last input row (padded row H) is the home row of a window row
// OH that does not exist; only window row OH - 1 reaches it. Home cells in
// the pad (padded row or column 0 when the pad is on the low side) are not
// written.
#include "maxpool3x3s2_vec.cuh"

namespace {

using namespace maxpool;

constexpr int kRows = 2;  // home rows a thread takes

// The arithmetic of a chain walk on a group of lanes: one float32 lane, or
// two bf16 lanes in packed bf16x2 instructions. The packed form is exact:
// comparing two bf16 values is comparing them as floats, and the weights
// (0, 1/2, 1 and their products, down to 2^-8) are bf16 values.
template <typename N>
struct Chain;

template <>
struct Chain<float> {
  static constexpr int kLanes = 1;
  __device__ static float one() { return 1.0f; }
  // (l, r) of a link from the running max m to the tap u
  __device__ static void link(float m, float u, float& l, float& r) {
    l = (m == u) ? 0.5f : ((m < u) ? 0.0f : 1.0f);
    r = (m == u) ? 0.5f : ((m > u) ? 0.0f : 1.0f);
  }
  __device__ static float max(float m, float u) {
    return (u > m || u != u) ? u : m;  // torch.maximum: NaN propagates
  }
  __device__ static float mul(float a, float b) { return a * b; }
  __device__ static float lane(float w, int) { return w; }
};

template <>
struct Chain<__nv_bfloat162> {
  using N = __nv_bfloat162;
  static constexpr int kLanes = 2;
  __device__ static N one() { return __float2bfloat162_rn(1.0f); }
  // ordered compares give 1 or 0 a lane (0 for NaN): l = 1 - [u > m] -
  // [u == m] / 2, r = 1 - [u < m] - [u == m] / 2, and (1, 1) for NaN
  __device__ static void link(N m, N u, N& l, N& r) {
    const N eq = __heq2(u, m), minus_half = __float2bfloat162_rn(-0.5f);
    l = __hfma2(eq, minus_half, __hsub2(one(), __hgt2(u, m)));
    r = __hfma2(eq, minus_half, __hsub2(one(), __hlt2(u, m)));
  }
  // the value of the running max, NaN once a tap was NaN; a 0 of either
  // sign compares as the chain's own 0 would
  __device__ static N max(N m, N u) { return __hmax2_nan(m, u); }
  __device__ static N mul(N a, N b) { return __hmul2(a, b); }
  __device__ static float lane(N w, int e) { return e == 0 ? __low2float(w) : __high2float(w); }
};

// The nine weights of a window's chain over its taps v[0..8].
template <typename N>
__device__ __forceinline__ void chain_weights(const N (&v)[9], N (&w)[9]) {
  using C = Chain<N>;
  N l[9], r[9];
  N m = v[0];
  r[0] = C::one();
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    C::link(m, v[j], l[j], r[j]);
    m = C::max(m, v[j]);
  }
  N s = C::one();  // l_{k+1} * ... * l_8
#pragma unroll
  for (int k = 8; k >= 0; --k) {
    w[k] = C::mul(r[k], s);
    if (k > 0) s = C::mul(s, l[k]);
  }
}

// A raw vector's lanes in groups: bf16 vectors in pairs, else one by one.
template <typename T, int V>
using Group = typename std::conditional<std::is_same<T, __nv_bfloat16>::value && V == 8,
                                        __nv_bfloat162, float>::type;

template <typename T, int V, typename Raw>
__device__ __forceinline__ Group<T, V> group(const Raw& raw, int p) {
  if constexpr (std::is_same<Group<T, V>, float>::value) {
    return lane<T>(raw, p);
  } else {
    const unsigned w = word(raw, p);
    return *reinterpret_cast<const __nv_bfloat162*>(&w);
  }
}

// acc += g * w, skipping w = 0. g * w is exact (w is 0 or a power of two),
// so one fused multiply-add rounds as a product and a sum would.
__device__ __forceinline__ void add(float& acc, float g, float w) {
  if (w != 0.0f) acc = __fmaf_rn(g, w, acc);
}

template <typename T, int V, int R>
__global__ void __launch_bounds__(128)
    maxpool3x3s2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            T* __restrict__ dx, int H, int W, int C, int OH, int OW,
                            int pad_top, int pad_left, float fill) {
  using Raw = typename Vec<T, V>::Raw;
  const int cvs = C / V;
  const int home_w = (W + pad_left + 1) / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cvs * home_w) return;
  const int cv = t % cvs, hx = t / cvs;
  const int hy0 = blockIdx.y * R, b = blockIdx.z;
  const int home_h = (H + pad_top + 1) / 2;
  const T* xb = x + (int64_t)b * H * W * C + cv * V;
  const T* gb = g + (int64_t)b * OH * OW * C + cv * V;
  T* db = dx + (int64_t)b * H * W * C + cv * V;

  // input columns of the padded columns 2hx-2 .. 2hx+2 (window hx-1 takes
  // 0..2, window hx takes 2..4; the home cells are 2 and 3)
  const int x0 = 2 * hx - 2 - pad_left;
  const bool has_left = hx >= 1 && hx - 1 < OW, has_right = hx < OW;
  const Raw pad = broadcast<T, V>(fill);
  Raw raw[3][5];
  float top[2][V], bot[2][V], nxt[2][V];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int i = 0; i < V; ++i) top[c][i] = bot[c][i] = nxt[c][i] = 0.0f;
  }

#pragma unroll
  for (int step = 0; step <= R; ++step) {
    const int wr = hy0 - 1 + step;  // window row; its taps are padded rows 2wr..2wr+2
    if (step > 0 && wr >= home_h) break;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if (step > 0 && dy == 0) {
#pragma unroll
        for (int c = 0; c < 5; ++c) raw[0][c] = raw[2][c];
        continue;
      }
      const int iy = 2 * wr + dy - pad_top;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const int ix = x0 + c;
        raw[dy][c] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                         ? load<T, V>(xb + (iy * W + ix) * C)
                         : pad;
      }
    }
    const bool row_ok = wr >= 0 && wr < OH;
    const bool left = row_ok && has_left, right = row_ok && has_right;
    const Raw gl = left ? load<T, V>(gb + (wr * OW + hx - 1) * C) : Raw{};
    const Raw gr = right ? load<T, V>(gb + (wr * OW + hx) * C) : Raw{};

    using N = Group<T, V>;
    constexpr int kLanes = Chain<N>::kLanes;
#pragma unroll
    for (int p = 0; p < V / kLanes; ++p) {
      N v[3][5];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int c = 0; c < 5; ++c) v[dy][c] = group<T, V>(raw[dy][c], p);
      }
      if (left) {
        const N tl[9] = {v[0][0], v[0][1], v[0][2], v[1][0], v[1][1],
                         v[1][2], v[2][0], v[2][1], v[2][2]};
        N w[9];
        chain_weights(tl, w);
        const N gv = group<T, V>(gl, p);
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
          const int i = p * kLanes + e;
          const float gi = Chain<N>::lane(gv, e);
          add(top[0][i], gi, Chain<N>::lane(w[2], e));
          add(bot[0][i], gi, Chain<N>::lane(w[5], e));
          add(nxt[0][i], gi, Chain<N>::lane(w[8], e));
        }
      }
      if (right) {
        const N tr[9] = {v[0][2], v[0][3], v[0][4], v[1][2], v[1][3],
                         v[1][4], v[2][2], v[2][3], v[2][4]};
        N w[9];
        chain_weights(tr, w);
        const N gv = group<T, V>(gr, p);
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
          const int i = p * kLanes + e;
          const float gi = Chain<N>::lane(gv, e);
          add(top[0][i], gi, Chain<N>::lane(w[0], e));
          add(top[1][i], gi, Chain<N>::lane(w[1], e));
          add(bot[0][i], gi, Chain<N>::lane(w[3], e));
          add(bot[1][i], gi, Chain<N>::lane(w[4], e));
          add(nxt[0][i], gi, Chain<N>::lane(w[6], e));
          add(nxt[1][i], gi, Chain<N>::lane(w[7], e));
        }
      }
    }

    if (step > 0) {  // home row wr is complete: write its cells that are inputs
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int iy = 2 * wr + a - pad_top;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ix = 2 * hx + c - pad_left;
          if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
          if (a == 0) {
            store<T, V>(db + (iy * W + ix) * C, top[c]);
          } else {
            store<T, V>(db + (iy * W + ix) * C, bot[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        top[c][i] = nxt[c][i];
        bot[c][i] = nxt[c][i] = 0.0f;
      }
    }
  }
}

template <typename T, int V>
void launch(const void* x, const void* g, void* dx, int B, int H, int W, int C, int OH, int OW,
            int pad_top, int pad_left, float fill, cudaStream_t s) {
  const int threads = 128;
  const int work = C / V * ((W + pad_left + 1) / 2);
  const int strips = ((H + pad_top + 1) / 2 + kRows - 1) / kRows;
  const dim3 grid((work + threads - 1) / threads, strips, B);
  maxpool3x3s2_bwd_kernel<T, V, kRows><<<grid, threads, 0, s>>>(
      (const T*)x, (const T*)g, (T*)dx, H, W, C, OH, OW, pad_top, pad_left, fill);
}

}  // namespace

// x, g, dx channels-last: x and dx [B, H, W, C], g [B, OH, OW, C]. dtype:
// 0 = float32, 1 = bfloat16; vec: channels a thread loads at once, 1 or a
// 16-byte vector (4 float32, 8 bf16; then C % vec == 0 and every pointer
// 16-byte aligned); fill as in the forward. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int metro_maxpool3x3s2_bwd(const void* x, const void* g, void* dx, int dtype, int vec,
                                      int B, int H, int W, int C, int OH, int OW, int pad_top,
                                      int pad_left, float fill, void* stream) {
  const void* ptrs[3] = {x, g, dx};
  const int strips = ((H + pad_top + 1) / 2 + kRows - 1) / kRows;
  if (!maxpool::shape_ok(dtype, vec, B, H, W, C, strips, ptrs, 3) ||
      (int64_t)OH * OW * C >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)B * H * W * C == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    (vec == 1 ? launch<float, 1> : launch<float, 4>)(x, g, dx, B, H, W, C, OH, OW, pad_top,
                                                     pad_left, fill, s);
  } else {
    (vec == 1 ? launch<__nv_bfloat16, 1> : launch<__nv_bfloat16, 8>)(
        x, g, dx, B, H, W, C, OH, OW, pad_top, pad_left, fill, s);
  }
  return (int)cudaGetLastError();
}
