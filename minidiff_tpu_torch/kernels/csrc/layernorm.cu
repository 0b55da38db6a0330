// LayerNorm forward and fused residual-add + LayerNorm forward for sm_90a.
//
// Replaces minidiff_tpu/kernels/layernorm.py:
//   ln_fwd    <- _fwd_kernel       (:84,  pallas_call in _pallas_ln_fwd)
//   addln_fwd <- _addln_fwd_kernel (:123, pallas_call in _pallas_addln_fwd)
//
// Semantics (the JAX module's contract): statistics in f32 for bf16 inputs,
// biased variance of the centred row, y = (x-mu)*rsqrt(var+eps)*g + b cast
// back to x's dtype.  addln_fwd forms t = x + a in the MODEL dtype (bf16
// rounding) before the f32 statistics and writes both t and LN(t), so its
// outputs equal an unfused add followed by ln_fwd bit for bit.
//
// Bound on the H100: bytes.  A row of d elements is read once and written
// once (twice for addln), against ~8 flops per element: three orders of
// magnitude under the ~295 flop/byte ridge.  Design: one warp per row, so
// both reductions are warp shuffles with no shared memory or block barrier;
// each lane moves 16-byte vectors (8 bf16 or 4 f32) from neighbouring
// addresses, and the row stays in registers between the mean pass, the
// centred-variance pass and the output pass, so x crosses HBM exactly once.
// At the decode path's 8 rows the launch is latency-bound; fusing it into
// its neighbours is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxVecsPerLane = 8;  // d <= 32 * 8 * VEC (2048 bf16, 1024 f32)

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
  // the add in the model dtype: f32 + f32 is already f32
  __device__ static float round(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  // bf16 + bf16 rounded once to bf16 (the sum of two bf16 is exact in f32)
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row.  ADD: x <- round_T(x + a), written to t, then normalised.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ a,
               const T* __restrict__ g, const T* __restrict__ b,
               T* __restrict__ t_out, T* __restrict__ y, int rows, int d,
               float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / V;
  const size_t base = static_cast<size_t>(row) * d;

  float v[kMaxVecsPerLane][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      Vec<T>::load(x + base + c * V, v[i]);
      if (ADD) {
        float av[V];
        Vec<T>::load(a + base + c * V, av);
#pragma unroll
        for (int j = 0; j < V; ++j) v[i][j] = Vec<T>::round(v[i][j] + av[j]);
        Vec<T>::store(t_out + base + c * V, v[i]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i][j];
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const float mu = warp_sum(sum) * inv_d;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecsPerLane; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] -= mu;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rsig = rsqrtf(warp_sum(sq) * inv_d + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float gv[V], bv[V];
      Vec<T>::load(g + c * V, gv);
      Vec<T>::load(b + c * V, bv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = v[i][j] * rsig * gv[j] + bv[j];
      Vec<T>::store(y + base + c * V, v[i]);
    }
  }
}

template <typename T, bool ADD>
int launch(const void* x, const void* a, const void* g, const void* b,
           void* t_out, void* y, int rows, int d, float eps, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_rows_kernel<T, ADD><<<blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(t_out), static_cast<T*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller has checked that every
// pointer is 16-byte aligned, d is a multiple of the vector width and
// d <= 32 * kMaxVecsPerLane * vector width.  Returns cudaGetLastError().
extern "C" int ln_fwd(const void* x, const void* g, const void* b, void* y,
                      int rows, int d, float eps, int dtype, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, nullptr, g, b, nullptr, y, rows, d, eps, stream);
  return launch<float, false>(x, nullptr, g, b, nullptr, y, rows, d, eps, stream);
}

// out holds (2, rows, d): out[0] = x + a, out[1] = LN(x + a).
extern "C" int addln_fwd(const void* x, const void* a, const void* g,
                         const void* b, void* out, int rows, int d, float eps,
                         int dtype, void* stream) {
  const size_t n = static_cast<size_t>(rows) * d;
  if (dtype == 1) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    return launch<__nv_bfloat16, true>(x, a, g, b, o, o + n, rows, d, eps, stream);
  }
  float* o = static_cast<float*>(out);
  return launch<float, true>(x, a, g, b, o, o + n, rows, d, eps, stream);
}

extern "C" int max_row_width(int dtype) {
  return 32 * kMaxVecsPerLane * (dtype == 1 ? 8 : 4);
}
