// First-order linear recurrence for sm_90a: y_t = a_t * y_{t-1} + b_t along
// T, with y_{-1} = 0, over (lead, T, C) contiguous operands.
//
// Replaces minidiff_tpu/kernels/scan.py _scan_kernel (:67), reached through
// _pallas_scan (pallas_call at :83).  Same contract: f32 or bf16 operands,
// the carry in f32, each output rounded once to the stored dtype (the carry
// itself is never rounded).  The op's VJPs are reversed linear scans
// (ops/definitions.py:487-561), so the same kernel serves the forward, the
// serving prefill and the backward.
//
// Bound on the H100: one multiply-add per element, so a, b and y crossing
// HBM once each bound it: 3 x lead x T x C elements over 3.35 TB/s (at the
// train step's (8, 1024, 32768) bf16, 1.61 GB in 0.481 ms).
//
// Design.  The TPU kernel's Hillis-Steele tile scan exists because Pallas
// walks its grid serially; here the channels are the parallelism.  One
// thread owns one (lead row, channel pair) -- two adjacent channels as one
// float2 or __nv_bfloat162 when C is even, one channel otherwise -- and
// walks T with its carry in registers, so a warp's loads are coalesced along
// C and a, b and y cross memory exactly once.  T is unrolled by kUnroll: the
// loads of kUnroll steps are issued before the dependent chain of
// multiply-adds that consumes them, which keeps loads in flight ahead of it.
// Each step is a rounded multiply, then a rounded add (__fmul_rn,
// __fadd_rn: never contracted into one FMA), the plain version's two f32
// operations in its order, so the two agree bit for bit.
// At a one-row prefill (lead 1) only C / 2 threads exist and the kernel is
// bound by latency; a chunked two-pass scan over T is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// loads and stores of VEC adjacent channels, converted to and from f32
template <typename T, int VEC> struct Io;

template <> struct Io<float, 1> {
  __device__ static void load(const float* p, float* out) { out[0] = __ldg(p); }
  __device__ static void store(float* p, const float* in) { *p = in[0]; }
};

template <> struct Io<float, 2> {
  __device__ static void load(const float* p, float* out) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
};

template <> struct Io<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *p = __float2bfloat16_rn(in[0]);
  }
};

template <> struct Io<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(in[0], in[1]);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ y,
            int lead, int t_len, int c) {
  using IO = Io<T, VEC>;
  const int groups = c / VEC;  // channel groups of one lead row
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= static_cast<long long>(lead) * groups) return;
  const int row = static_cast<int>(gid / groups);
  const int c0 = static_cast<int>(gid % groups) * VEC;
  const size_t stride = static_cast<size_t>(c);
  const size_t base = static_cast<size_t>(row) * t_len * stride + c0;
  const T* pa = a + base;
  const T* pb = b + base;
  T* py = y + base;

  float carry[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) carry[v] = 0.f;

  int t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float fa[kUnroll][VEC], fb[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      IO::load(pa + (t + u) * stride, fa[u]);
      IO::load(pb + (t + u) * stride, fb[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) carry[v] = __fadd_rn(__fmul_rn(fa[u][v], carry[v]), fb[u][v]);
      IO::store(py + (t + u) * stride, carry);
    }
  }
  for (; t < t_len; ++t) {
    float fa[VEC], fb[VEC];
    IO::load(pa + t * stride, fa);
    IO::load(pb + t * stride, fb);
#pragma unroll
    for (int v = 0; v < VEC; ++v) carry[v] = __fadd_rn(__fmul_rn(fa[v], carry[v]), fb[v]);
    IO::store(py + t * stride, carry);
  }
}

template <typename T, int VEC>
int launch(const void* a, const void* b, void* y, int lead, int t_len, int c,
           cudaStream_t st) {
  const long long threads = static_cast<long long>(lead) * (c / VEC);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  scan_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      lead, t_len, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, const void* b, void* y, int lead, int t_len, int c,
             cudaStream_t st) {
  if (c % 2 == 0) return launch<T, 2>(a, b, y, lead, t_len, c, st);
  return launch<T, 1>(a, b, y, lead, t_len, c, st);
}

}  // namespace

// a, b, y (lead, t, c), contiguous and 16-byte aligned; lead, t, c >= 1.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int linear_scan(const void* a, const void* b, void* y, int lead,
                           int t, int c, int dtype, void* stream) {
  if (lead < 1 || t < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, b, y, lead, t, c, st);
  return dispatch<float>(a, b, y, lead, t, c, st);
}
