// Helpers shared by the row kernels (layernorm.cu, rmsnorm.cu, xent.cu):
// 16-byte vector loads and stores of a row's elements as f32, and warp
// reductions by shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowwise {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  // the 16 bytes as loaded, unpacked later (a load issued apart from its use)
  using Raw = float4;
  __device__ static Raw fetch(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void unpack(const Raw& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void load(const float* p, float* out) { unpack(fetch(p), out); }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
  // a value rounded to the model dtype: f32 is already f32
  __device__ static float round(float v) { return v; }
  // the 16 bytes of x + a, as stored
  __device__ static Raw add(const Raw& x, const Raw& a) {
    return make_float4(x.x + a.x, x.y + a.y, x.z + a.z, x.w + a.w);
  }
  __device__ static void store_raw(float* p, const Raw& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw fetch(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const Raw& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* out) { unpack(fetch(p), out); }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  // rounded once to bf16 (the sum of two bf16 is exact in f32, so an add in
  // f32 followed by this equals the add in bf16)
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // the 16 bytes of x + a, each pair added and rounded once to bf16 (the
  // correctly rounded bf16 sum: round(x + a) of the values in f32)
  __device__ static Raw add(const Raw& x, const Raw& a) {
    Raw t;
    const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
    __nv_bfloat162* ht = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) ht[i] = __hadd2(hx[i], ha[i]);
    return t;
  }
  __device__ static void store_raw(__nv_bfloat16* p, const Raw& v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one f32 value stored in the row's dtype, rounded once
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// warp_sum over groups of `span` lanes (a power of two): lane l adds lane
// l ^ o for each o < span, so every group whose lanes hold the same values
// ends with the same bits.
__device__ __forceinline__ float group_sum(float v, int span) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < span) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// warp_max over groups of `span` lanes, as group_sum
__device__ __forceinline__ float group_max(float v, int span) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < span) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the lanes that combine a CTA's warps' partials after an exchange: the
// fewest (a power of two) that hold one partial each
__device__ __forceinline__ int warp_span(int warps) {
  int span = 1;
  while (span < warps) span *= 2;
  return span;
}

}  // namespace rowwise
