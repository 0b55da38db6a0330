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
// it once.  Any V that is a multiple of the vector width works.

#include "rowwise.cuh"

namespace {

using rowwise::Vec;
using rowwise::warp_max;
using rowwise::warp_sum;

constexpr int kWarpsPerBlock = 4;

// m and sum(exp(z - m)) of one row, every lane holding both.
template <typename T>
__device__ __forceinline__ void row_stats(const T* zr, int nvec, int lane,
                                          float* m_out, float* s_out) {
  constexpr int V = Vec<T>::N;
  float m = -3.402823466e38f;
  for (int c = lane; c < nvec; c += 32) {
    float zv[V];
    Vec<T>::load(zr + c * V, zv);
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, zv[j]);
  }
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float zv[V];
    Vec<T>::load(zr + c * V, zv);
#pragma unroll
    for (int j = 0; j < V; ++j) s += expf(zv[j] - m);
  }
  *m_out = m;
  *s_out = warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
xent_fwd_kernel(const T* __restrict__ z, const int* __restrict__ lab,
                float* __restrict__ loss, int rows, int v) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* zr = z + static_cast<size_t>(row) * v;
  float m, s;
  row_stats(zr, v / Vec<T>::N, lane, &m, &s);
  if (lane == 0) {
    const int l = lab[row];
    const float zl = (l >= 0 && l < v) ? rowwise::to_f32(zr[l]) : 0.f;
    loss[row] = (logf(s) + m) - zl;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
xent_bwd_kernel(const T* __restrict__ z, const int* __restrict__ lab,
                const float* __restrict__ g, T* __restrict__ dz, int rows,
                int v) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * v;
  const int nvec = v / V;
  float m, s;
  row_stats(z + base, nvec, lane, &m, &s);
  const int l = lab[row];
  const float gr = g[row];
  for (int c = lane; c < nvec; c += 32) {
    float zv[V];
    Vec<T>::load(z + base + c * V, zv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float p = expf(zv[j] - m) / s;
      zv[j] = (p - (c * V + j == l ? 1.f : 0.f)) * gr;
    }
    Vec<T>::store(dz + base + c * V, zv);
  }
}

inline int blocks_for(int rows) {
  return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

// z (rows, v) contiguous and 16-byte aligned, v a multiple of 8 (bf16) or 4
// (f32); lab (rows,) int32; loss (rows,) f32.  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int xent_fwd(const void* z, const void* lab, void* loss, int rows,
                        int v, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lab);
  float* out = static_cast<float*>(loss);
  if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), lb, out, rows, v);
  else
    xent_fwd_kernel<float><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(z), lb, out, rows, v);
  return static_cast<int>(cudaGetLastError());
}

// g (rows,) f32, the cotangent of each row's loss; dz like z.
extern "C" int xent_bwd(const void* z, const void* lab, const void* g,
                        void* dz, int rows, int v, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lab);
  const float* gr = static_cast<const float*>(g);
  if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), lb, gr,
        static_cast<__nv_bfloat16*>(dz), rows, v);
  else
    xent_bwd_kernel<float><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(z), lb, gr, static_cast<float*>(dz), rows, v);
  return static_cast<int>(cudaGetLastError());
}
