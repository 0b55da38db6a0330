// Softmax cross-entropy over integer labels, forward and backward, for
// sm_90a.
//
// Replaces minidiff_tpu/kernels/xent.py:
//   xent_fwd <- _fwd_kernel (:64, pallas_call in _pallas_xent_fwd)
//   xent_bwd <- _bwd_kernel (:74, pallas_call in _pallas_xent_bwd)
//
// Semantics (the JAX module's contract), per row r of the (rows, V) logits,
// all in f32 whatever the logits' dtype:
//   m = max(z_r);  lse = log(sum(exp(z_r - m))) + m
//   loss_r = lse - z_r[label_r]                       (f32 out)
//   dz_r   = (exp(z_r - m) / sum(exp(z_r - m)) - onehot(label_r)) * g_r
//                                                     (cast to z's dtype)
// A label outside [0, V) matches no column, as the TPU kernel's iota
// compare: z[label] counts as 0 and the one-hot row is empty.
//
// Bound on the H100: bytes.  The forward reads the logits once and writes
// one f32 per row; the backward reads them once and writes them once; about
// 5 flops and one exp per element, far under the ridge.  Design: one warp
// per row, lanes on neighbouring 16-byte vectors.  The passes over the row
// (max, sum of exps, and for the backward the output) re-read it from L1:
// a row of the train step's V = 512 is 1 KB in bf16, so device memory sees
// it once.  A row that is no whole number of aligned vectors (V = 10 in
// the tape's MLP) is read one element per lane instead, so any V works.

#include "rowwise.cuh"

namespace {

using rowwise::Vec;
using rowwise::warp_max;
using rowwise::warp_sum;

constexpr int kWarpsPerBlock = 4;

// W consecutive columns of a row as f32: one 16-byte vector (W = Vec::N)
// when every row is a whole number of aligned vectors, else one element.
template <typename T, bool kVec>
struct Chunk;

template <typename T>
struct Chunk<T, true> {
  static constexpr int W = Vec<T>::N;
  __device__ static void load(const T* p, float* out) { Vec<T>::load(p, out); }
  __device__ static void store(T* p, const float* in) { Vec<T>::store(p, in); }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
struct Chunk<T, false> {
  static constexpr int W = 1;
  __device__ static void load(const T* p, float* out) { out[0] = rowwise::to_f32(*p); }
  __device__ static void store(T* p, const float* in) { put(p, in[0]); }
};

// m and sum(exp(z - m)) of one row, every lane holding both.
template <typename T, bool kVec>
__device__ __forceinline__ void row_stats(const T* zr, int v, int lane,
                                          float* m_out, float* s_out) {
  using C = Chunk<T, kVec>;
  const int nchunk = v / C::W;
  float m = -3.402823466e38f;
  for (int c = lane; c < nchunk; c += 32) {
    float zv[C::W];
    C::load(zr + c * C::W, zv);
#pragma unroll
    for (int j = 0; j < C::W; ++j) m = fmaxf(m, zv[j]);
  }
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < nchunk; c += 32) {
    float zv[C::W];
    C::load(zr + c * C::W, zv);
#pragma unroll
    for (int j = 0; j < C::W; ++j) s += expf(zv[j] - m);
  }
  *m_out = m;
  *s_out = warp_sum(s);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
xent_fwd_kernel(const T* __restrict__ z, const int* __restrict__ lab,
                float* __restrict__ loss, int rows, int v) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* zr = z + static_cast<size_t>(row) * v;
  float m, s;
  row_stats<T, kVec>(zr, v, lane, &m, &s);
  if (lane == 0) {
    const int l = lab[row];
    const float zl = (l >= 0 && l < v) ? rowwise::to_f32(zr[l]) : 0.f;
    loss[row] = (logf(s) + m) - zl;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
xent_bwd_kernel(const T* __restrict__ z, const int* __restrict__ lab,
                const float* __restrict__ g, T* __restrict__ dz, int rows,
                int v) {
  using C = Chunk<T, kVec>;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * v;
  const int nchunk = v / C::W;
  float m, s;
  row_stats<T, kVec>(z + base, v, lane, &m, &s);
  const int l = lab[row];
  const float gr = g[row];
  for (int c = lane; c < nchunk; c += 32) {
    float zv[C::W];
    C::load(z + base + c * C::W, zv);
#pragma unroll
    for (int j = 0; j < C::W; ++j) {
      const float p = expf(zv[j] - m) / s;
      zv[j] = (p - (c * C::W + j == l ? 1.f : 0.f)) * gr;
    }
    C::store(dz + base + c * C::W, zv);
  }
}

inline int blocks_for(int rows) {
  return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// every row a whole number of 16-byte vectors, from 16-byte aligned bases
template <typename T>
bool vector_rows(int v, const void* a, const void* b) {
  return v % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
void launch_fwd(const void* z, const int* lab, float* loss, int rows, int v,
                cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  if (vector_rows<T>(v, z, z))
    xent_fwd_kernel<T, true><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, loss, rows, v);
  else
    xent_fwd_kernel<T, false><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, loss, rows, v);
}

template <typename T>
void launch_bwd(const void* z, const int* lab, const float* g, void* dz,
                int rows, int v, cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  T* dzt = static_cast<T*>(dz);
  if (vector_rows<T>(v, z, dz))
    xent_bwd_kernel<T, true><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, g, dzt, rows, v);
  else
    xent_bwd_kernel<T, false><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, g, dzt, rows, v);
}

}  // namespace

// z (rows, v) contiguous, any v; lab (rows,) int32; loss (rows,) f32.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int xent_fwd(const void* z, const void* lab, void* loss, int rows,
                        int v, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lab);
  float* out = static_cast<float*>(loss);
  if (dtype == 1)
    launch_fwd<__nv_bfloat16>(z, lb, out, rows, v, st);
  else
    launch_fwd<float>(z, lb, out, rows, v, st);
  return static_cast<int>(cudaGetLastError());
}

// g (rows,) f32, the cotangent of each row's loss; dz like z.
extern "C" int xent_bwd(const void* z, const void* lab, const void* g,
                        void* dz, int rows, int v, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lab);
  const float* gr = static_cast<const float*>(g);
  if (dtype == 1)
    launch_bwd<__nv_bfloat16>(z, lb, gr, dz, rows, v, st);
  else
    launch_bwd<float>(z, lb, gr, dz, rows, v, st);
  return static_cast<int>(cudaGetLastError());
}
