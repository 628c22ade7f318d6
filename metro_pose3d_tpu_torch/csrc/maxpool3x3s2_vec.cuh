// Loads, lanes and stores shared by the stem pool's forward and backward
// kernels (maxpool3x3s2.cu, maxpool3x3s2_bwd.cu).
//
// A thread moves V channels of one pixel at a time: a 16-byte vector (8 bf16
// or 4 float32 channels) read with one `ld.global.nc.v4`, or one element (the
// scalar variant, for C not a multiple of the vector or a pointer not 16-byte
// aligned). Lanes are compared and summed in float32; a bf16 lane widens by a
// shift and narrows by rounding to nearest even, exact for a value that was
// bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace maxpool {

template <typename T, int V>
struct Vec {
  static_assert(V == 1 || V * sizeof(T) == 16, "a vector is one element or 16 bytes");
  using Raw = typename std::conditional<V == 1, T, uint4>::type;
};

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// lane i of a raw vector as float
template <typename T>
__device__ __forceinline__ float lane(const uint4& r, int i) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word(r, i));
  } else {
    const unsigned w = word(r, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}
template <typename T>
__device__ __forceinline__ float lane(float r, int) { return r; }
template <typename T>
__device__ __forceinline__ float lane(__nv_bfloat16 r, int) { return __bfloat162float(r); }

// the raw vector whose every lane is `fill` (-inf or 0.0: exact in bf16)
template <typename T, int V>
__device__ __forceinline__ typename Vec<T, V>::Raw broadcast(float fill) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      return fill;
    } else {
      return __float2bfloat16_rn(fill);
    }
  } else {
    unsigned w = __float_as_uint(fill);
    if constexpr (!std::is_same<T, float>::value) w = (w >> 16) | (w & 0xffff0000u);
    return make_uint4(w, w, w, w);
  }
}

template <typename T, int V>
__device__ __forceinline__ typename Vec<T, V>::Raw load(const T* p) {
  if constexpr (V == 1) {
    return __ldg(p);
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// store V float lanes in T, each rounded once
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      *p = f[0];
    } else {
      *p = __float2bfloat16_rn(f[0]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                              __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The entry points' checks: a vector width the kernels have, C a multiple of
// it, 16-byte aligned pointers for the vector, and sizes that the grid and
// the 32-bit offsets within one image can hold.
inline bool shape_ok(int dtype, int vec, int B, int H, int W, int C, int rows,
                     const void* const* ptrs, int n_ptrs) {
  const int size = dtype == 0 ? 4 : 2;
  if (dtype != 0 && dtype != 1) return false;
  if (vec != 1 && vec * size != 16) return false;
  if (C % vec != 0 || B > 65535 || rows > 65535) return false;
  if ((int64_t)H * W * C >= ((int64_t)1 << 31)) return false;
  if (vec != 1) {
    for (int i = 0; i < n_ptrs; ++i) {
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    }
  }
  return true;
}

}  // namespace maxpool
