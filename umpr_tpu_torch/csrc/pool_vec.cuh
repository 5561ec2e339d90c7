// Vector loads and stores shared by K5 (bias_relu_pool.cu) and K6
// (bias_relu_pool_bwd.cu): V channels of one position as one 16-byte
// access, or V = 1.  The IO type T is float (V = 4) or bf16 (V = 8); the
// values are f32 in registers (a bf16 value is exact in f32), and a store
// rounds to T to nearest even, as XLA's astype does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pool_vec {

using bf16 = __nv_bfloat16;

template <class T>
constexpr int kVec = 16 / sizeof(T);  // channels of one 16-byte access

template <class T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  static_assert(V == 1 || V == kVec<T>, "V is 1 or one 16-byte vector");
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, bf16>::value)
      v[0] = __bfloat162float(*p);
    else
      v[0] = *p;
  } else if constexpr (std::is_same<T, bf16>::value) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
}

template <class T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, bf16>::value)
      *p = __float2bfloat16_rn(v[0]);
    else
      *p = v[0];
  } else if constexpr (std::is_same<T, bf16>::value) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// V window indices (0..3) as one V-byte access (V = 1, 4 or 8)
template <int V>
__device__ __forceinline__ void load_idx(const uint8_t* p, uint8_t (&k)[V]) {
  if constexpr (V == 1) {
    k[0] = *p;
  } else {
    uint32_t w[V / 4];
    if constexpr (V == 8) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x; w[1] = t.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) k[j] = (w[j / 4] >> (8 * (j % 4))) & 0xff;
  }
}

template <int V>
__device__ __forceinline__ void store_idx(uint8_t* p, const uint8_t (&k)[V]) {
  if constexpr (V == 1) {
    *p = k[0];
  } else {
    uint32_t w[V / 4] = {};
#pragma unroll
    for (int j = 0; j < V; ++j) w[j / 4] |= (uint32_t)k[j] << (8 * (j % 4));
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

}  // namespace pool_vec
