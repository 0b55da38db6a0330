// Block-per-row LayerNorm and RMSNorm, forward and backward, for rows too
// wide for one warp's registers: rmsnorm.cu runs every row through these,
// layernorm.cu the rows wider than its warp-per-row kernels take (2,048
// bf16 or 1,024 f32 values).
//
// Design: one thread block owns one row.  Thread t holds the 16-byte
// vectors t, t + blockDim.x, ... of the row in registers (NV of them, a
// power of two chosen per launch), so x still crosses device memory once
// per pass, as in the warp-per-row kernels; a row of d <= kMaxWidth needs
// at most 8 f32 or 4 bf16 vectors a thread at kMaxThreads threads.  Each
// row statistic is a warp shuffle sum, then the warps' partial sums through
// shared memory, added by every thread in the same order (so every thread
// holds the same value and the result does not depend on scheduling).
//
// The backward's block walks a run of rows one after the other; a thread
// owns the same columns in every row, so it keeps its dg (and db) sums in
// registers and writes them once as its block's f32 partial row.  The
// caller sums the partial rows: no atomics, the same result on every run.
//
// That backward walks its rows as one chain: load x, reduce (two
// barriers), load dy and g, reduce again (two more), load g again, store
// dx.  Two dependent device-memory round trips and four barriers a row,
// with nothing of the next row in flight, and a few KB in flight per SM
// where the HBM rate asks ~25-40 KB (Little's law at ~1-2 us): at (8192,
// 4096) bf16 it ran at twice its bound.
//
// norm_wave_kernel is the forward of rms_fwd, ln_fwd, addrms_fwd and
// addln_fwd at decode-sized row counts (kernels.layernorm.norm_fwd_plan
// sends them there; see the kernel).  A build with -DNORM_FWD_V1 takes the
// routes above for every row, as before the one-wave kernel (chip_smoke.py
// times the two in turns).  norm_ring_bwd_kernel is the backward of rms_bwd,
// ln_bwd and addln_bwd at every row count (kernels.layernorm.norm_bwd_plan;
// see the kernel).
#pragma once

#include "rowwise.cuh"
#include "wgmma.cuh"

namespace rowblock {

using rowwise::group_sum;
using rowwise::Vec;
using rowwise::warp_sum;

constexpr int kMaxThreads = 256;
constexpr int kMaxWidth = 8192;  // the JAX kernels' widest row

// vectors a thread holds at most for type T: 4 for bf16, 8 for f32
template <typename T>
constexpr int max_nv() {
  return kMaxWidth / (kMaxThreads * Vec<T>::N);
}

// The K values summed over the block; every thread gets the K sums.
// red: shared scratch of K * 32 floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * 32 + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[k * 32 + w];
    v[k] = s;
  }
  __syncthreads();  // red is written again by the next call
}

// Statistics of the row held in xv (a thread's vectors; c < nvec valid):
// RMS: xv unchanged, returns rsqrt(mean(x^2) + eps).  LN: xv becomes
// x - mean, returns rsqrt(mean((x - mean)^2) + eps).
template <typename T, int NV, bool RMS>
__device__ __forceinline__ float row_rsig(float (&xv)[NV][Vec<T>::N], int nvec,
                                          float inv_d, float eps, float* red) {
  constexpr int V = Vec<T>::N;
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (threadIdx.x + i * blockDim.x < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) s[0] += RMS ? xv[i][j] * xv[i][j] : xv[i][j];
    }
  }
  block_sum<1>(s, red);
  if (RMS) return rsqrtf(s[0] * inv_d + eps);
  const float mu = s[0] * inv_d;
  s[0] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (threadIdx.x + i * blockDim.x < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xv[i][j] -= mu;
        s[0] += xv[i][j] * xv[i][j];
      }
    }
  }
  block_sum<1>(s, red);
  return rsqrtf(s[0] * inv_d + eps);
}

// One block per row.  ADD: x <- round_T(x + a), written to t_out, then
// normalised.  RMS: y = x * rsig * g; LN: y = (x - mu) * rsig * g + b.
template <typename T, int NV, bool RMS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                const T* __restrict__ g, const T* __restrict__ b,
                T* __restrict__ t_out, T* __restrict__ y, int d, float eps) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[32];
  const int nvec = d / V;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  float v[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      Vec<T>::load(x + base + c * V, v[i]);
      if (ADD) {
        float av[V];
        Vec<T>::load(a + base + c * V, av);
#pragma unroll
        for (int j = 0; j < V; ++j) v[i][j] = Vec<T>::round(v[i][j] + av[j]);
        Vec<T>::store(t_out + base + c * V, v[i]);
      }
    }
  }
  const float rsig = row_rsig<T, NV, RMS>(v, nvec, 1.f / static_cast<float>(d),
                                          eps, red);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float gv[V], bv[V];
      Vec<T>::load(g + c * V, gv);
      if (!RMS) Vec<T>::load(b + c * V, bv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[i][j] = RMS ? v[i][j] * rsig * gv[j] : v[i][j] * rsig * gv[j] + bv[j];
      Vec<T>::store(y + base + c * V, v[i]);
    }
  }
}

// Block b takes rows [b*rows_per_block, (b+1)*rows_per_block), one at a
// time.  With xhat the normalised row and w = dy * g:
//   RMS: dx = (w - xhat * mean(w * xhat)) * rsig
//   LN:  dx = (w - mean(w) - xhat * mean(w * xhat)) * rsig
// ADD: dx = round_T(dx) + g0.  dgp (and dbp for LN): (gridDim.x, d) f32
// partial sums of dy * xhat (and dy) over the block's rows.
template <typename T, int NV, bool RMS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ dy, const T* __restrict__ g0,
                T* __restrict__ dx, float* __restrict__ dgp,
                float* __restrict__ dbp, int rows, int d, int rows_per_block,
                float eps) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[2 * 32];
  const int nvec = d / V;
  const float inv_d = 1.f / static_cast<float>(d);

  float dg_acc[NV][V], db_acc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) dg_acc[i][j] = db_acc[i][j] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * d;
    float xv[NV][V], dv[NV][V];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) Vec<T>::load(x + base + c * V, xv[i]);
    }
    const float rsig = row_rsig<T, NV, RMS>(xv, nvec, inv_d, eps, red);

    // xv becomes xhat; sums of w (LN) and w * xhat; this thread's dg, db
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) {
        float gv[V];
        Vec<T>::load(dy + base + c * V, dv[i]);
        Vec<T>::load(g + c * V, gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = xv[i][j] * rsig;
          const float w = dv[i][j] * gv[j];
          xv[i][j] = xh;
          s[0] += w;
          s[1] += w * xh;
          dg_acc[i][j] += dv[i][j] * xh;
          if (!RMS) db_acc[i][j] += dv[i][j];
        }
      }
    }
    block_sum<2>(s, red);
    const float m1 = s[0] * inv_d;
    const float m2 = s[1] * inv_d;

#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) {
        float gv[V], o[V];
        Vec<T>::load(g + c * V, gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float w = dv[i][j] * gv[j];
          o[j] = RMS ? (w - xv[i][j] * m2) * rsig
                     : (w - m1 - xv[i][j] * m2) * rsig;
        }
        if (ADD) {
          float g0v[V];
          Vec<T>::load(g0 + base + c * V, g0v);
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = Vec<T>::round(o[j]) + g0v[j];
        }
        Vec<T>::store(dx + base + c * V, o);
      }
    }
  }

  // this block's partial rows: each column has one owner thread
  const size_t pbase = static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        Vec<float>::store(dgp + pbase + c * V + j, &dg_acc[i][j]);
        if (!RMS) Vec<float>::store(dbp + pbase + c * V + j, &db_acc[i][j]);
      }
    }
  }
}

// The vectors per thread (a power of two) and the threads per block (a
// multiple of 32, at most kMaxThreads) for a row of nvec vectors.
inline void row_shape(int nvec, int* nv, int* threads) {
  int n = 1;
  while (n * kMaxThreads < nvec) n *= 2;
  *nv = n;
  *threads = ((nvec + n - 1) / n + 31) / 32 * 32;
}

// Launch the forward for rows of d values (d a multiple of the vector
// width, at most kMaxWidth); t_out is written only with ADD.
template <typename T, bool RMS, bool ADD, int NV = 1>
int launch_fwd(const void* x, const void* a, const void* g, const void* b,
               void* t_out, void* y, int rows, int d, float eps,
               void* stream) {
  if constexpr (NV > max_nv<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    int nv, threads;
    row_shape(d / Vec<T>::N, &nv, &threads);
    if (nv > NV)
      return launch_fwd<T, RMS, ADD, 2 * NV>(x, a, g, b, t_out, y, rows, d,
                                              eps, stream);
    norm_fwd_kernel<T, NV, RMS, ADD><<<rows, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(a),
        static_cast<const T*>(g), static_cast<const T*>(b),
        static_cast<T*>(t_out), static_cast<T*>(y), d, eps);
    return static_cast<int>(cudaGetLastError());
  }
}

// Launch the backward over `blocks` blocks; dbp is written only for LN.
template <typename T, bool RMS, bool ADD, int NV = 1>
int launch_bwd(const void* x, const void* g, const void* dy, const void* g0,
               void* dx, void* dgp, void* dbp, int rows, int d, int blocks,
               float eps, void* stream) {
  if constexpr (NV > max_nv<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    int nv, threads;
    row_shape(d / Vec<T>::N, &nv, &threads);
    if (nv > NV)
      return launch_bwd<T, RMS, ADD, 2 * NV>(x, g, dy, g0, dx, dgp, dbp, rows,
                                              d, blocks, eps, stream);
    const int rows_per_block = (rows + blocks - 1) / blocks;
    norm_bwd_kernel<T, NV, RMS, ADD><<<blocks, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const T*>(dy), static_cast<const T*>(g0),
        static_cast<T*>(dx), static_cast<float*>(dgp),
        static_cast<float*>(dbp), rows, d, rows_per_block, eps);
    return static_cast<int>(cudaGetLastError());
  }
}

#ifdef NORM_FWD_V1
constexpr bool kFwdV1 = true;
#else
constexpr bool kFwdV1 = false;
#endif

// The one-wave forward's widest CTA, and its 16-byte vectors a thread: the
// fewest (a power of two) with which kWaveMaxThreads threads hold the row,
// so that every load of a thread is in flight at once.
constexpr int kWaveMaxThreads = 512;

template <typename T>
constexpr int wave_max_vecs() {
  return kMaxWidth / (kWaveMaxThreads * Vec<T>::N);  // 2 for bf16, 4 for f32
}

// The correctly rounded f32 reciprocals of the counts 1..kRcpMaxCount (the
// most values a warp holds: of the one-wave kernel's CTAs, and of the
// narrower ring CTAs of norm_ring_bwd_kernel; 0 maps to 0): a ragged part's
// mean is its sum times the reciprocal of its count.  The kernels divide
// nowhere, 1/d comes from the host: an IEEE division's slow path is a
// called subroutine, and ptxas spilled the registers it saved around it.
constexpr int kRcpMaxCount = 32 * kMaxWidth / kMaxThreads;

struct RcpTable {
  float r[kRcpMaxCount + 1];
};

constexpr RcpTable rcp_table() {
  RcpTable t{};
  for (int n = 1; n <= kRcpMaxCount; ++n) t.r[n] = 1.f / static_cast<float>(n);
  return t;
}

__constant__ RcpTable kRcp = rcp_table();

// LayerNorm's statistics by Chan's formula in its k-part form (see
// norm_wave_kernel).  A thread holds `held` of its NV vectors of the row
// (vectors threadIdx.x + i * blockDim.x); its part's mean is its sum times
// part_rcp (a power of two's reciprocal when whole, else the table's).
template <typename T, int NV>
__device__ __forceinline__ float part_rcp(int held) {
  return held == NV ? 1.f / (NV * Vec<T>::N) : kRcp.r[held * Vec<T>::N];
}

// The vectors of a row of nvec that warp `warp` of a CTA of `threads`
// holds, NV a thread at most; its part's mean is its sum times warp_rcp.
template <int NV>
__device__ __forceinline__ int warp_vecs(int nvec, int threads, int warp) {
  int wv = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) wv += min(32, max(0, nvec - i * threads - 32 * warp));
  return wv;
}

template <typename T, int NV>
__device__ __forceinline__ float warp_rcp(int wv) {
  return wv == 32 * NV ? 1.f / (32 * NV * Vec<T>::N) : kRcp.r[wv * Vec<T>::N];
}

// One part's term of the k-part merge onto the whole's mean: a part of
// count c, mean m and centred sum of squares q adds q + c (m - mean)^2 to
// the whole's centred sum of squares, and a part with sums B = sum(w) and
// A = sum(w (x - m)) adds A + (m - mean) B to the whole's sum(w (x -
// mean)).  The caller sums the terms (shuffles within a warp, shuffles
// over the warps' partials after the exchange).
__device__ __forceinline__ float chan_q(float q, float c, float m, float mean) {
  const float e = m - mean;
  return q + c * e * e;
}

__device__ __forceinline__ float chan_a(float a, float b, float m, float mean) {
  return a + (m - mean) * b;
}

inline int wave_vecs(int nvec) {
  int n = 1;
  while (n * kWaveMaxThreads < nvec) n *= 2;
  return n;
}

inline int wave_threads(int nvec, int vecs) {
  return ((nvec + vecs - 1) / vecs + 31) / 32 * 32;
}

// One CTA per row, at decode-sized row counts, where a launch's latency and
// not its bytes bounds the forward (an (8, 4096) bf16 row block is 128 KB:
// 0.04 us at the HBM rate, against ~3 us per launch of the kernels above).
// The design takes the serial steps out of the latency chain:
// - one load wave: each thread fetches its vectors of x, a (ADD), g (and b)
//   before any reduction, so the weights' and the residual's round trips
//   overlap x's instead of following it or a barrier;
// - width over depth: a row spread over up to kWaveMaxThreads threads of
//   one vector each where it fits (wave_vecs), all loads of a thread in
//   flight at once;
// - ADD: t = round_T(x + a) is formed in registers, packed as it is
//   stored (Vec::add), and stored to t_out before the exchange, so its
//   write drains under the reduction; the statistics and y are then those
//   of the rounded t, in the order below, so y equals the plain kernel's
//   on t bit for bit;
// - one exchange per row: warp shuffles, then each warp's partial through
//   shared memory and one barrier, after which every warp combines the
//   warps' partials by the same shuffles (group_sum over the fewest lanes,
//   a power of two, that hold one partial each, lane l taking warp l's), so
//   every thread gets the same bits.  A CTA makes one exchange, so its
//   scratch is written once and needs no trailing barrier.
// RMS: the partial is a sum of squares.  LN: each part of the row (a
// thread's values, a warp's) carries its count c, mean m and centred sum of
// squares q, and parts combine by Chan's formula in its k-part form,
//   q = sum_k [q_k + c_k (m_k - m)^2],  m = (sum of the values) / c,
// so the statistics are those of the centred row (no cancelling one-pass
// sum of squares), and the combination is two sums of independent terms
// (shuffles within a warp, shuffles over the warps' partials after the
// exchange), not a chain of pairwise merges.  Sums are taken in a fixed
// order, so every run gets the same bits.  Statistics in f32; y rounded
// once to T.
template <typename T, int NV, bool RMS, bool ADD>
__global__ void __launch_bounds__(kWaveMaxThreads)
norm_wave_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ g, const T* __restrict__ b,
                 T* __restrict__ t_out, T* __restrict__ y, int d, float inv_d,
                 float eps) {
  constexpr int V = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
  // each warp's partial: RMS its sum of squares; LN (sum, mean, centred sum
  // of squares, count)
  __shared__ float4 red[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int span = rowwise::warp_span(warps);  // the lanes that combine the warps' partials
  const int part = lane & (span - 1);  // the warp whose partial this lane takes
  const int nvec = d / V;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  Raw xr[NV], ar[NV], gr[NV], br[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      xr[i] = Vec<T>::fetch(x + base + c * V);
      if (ADD) ar[i] = Vec<T>::fetch(a + base + c * V);
      gr[i] = Vec<T>::fetch(g + c * V);
      if (!RMS) br[i] = Vec<T>::fetch(b + c * V);
    }
  }

  float v[NV][V];
  int held = 0;  // this thread's vectors of the row
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      if (ADD) {
        // t packed as stored: one rounded add per value, no repacking
        const Raw t = Vec<T>::add(xr[i], ar[i]);
        Vec<T>::store_raw(t_out + base + c * V, t);
        Vec<T>::unpack(t, v[i]);
      } else {
        Vec<T>::unpack(xr[i], v[i]);
      }
      ++held;
#pragma unroll
      for (int j = 0; j < V; ++j) s += RMS ? v[i][j] * v[i][j] : v[i][j];
    }
  }

  float rsig, mean = 0.f;
  if (RMS) {
    s = warp_sum(s);
    if (lane == 0) red[warp].x = s;
    __syncthreads();
    rsig = rsqrtf(group_sum(part < warps ? red[part].x : 0.f, span) * inv_d + eps);
  } else {
    // this thread's part: count, mean, centred sum of squares (the mean of
    // NV * V values, a power of two, by a constant reciprocal)
    const float c = static_cast<float>(held * V);
    const float m = s * part_rcp<T, NV>(held);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < held) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float e = v[i][j] - m;
          q += e * e;
        }
      }
    }
    // the warp's part (every warp holds a vector of the row): its count is
    // V for each vector its lanes hold
    const int wv = warp_vecs<NV>(nvec, blockDim.x, warp);
    const float cw = static_cast<float>(wv * V);
    const float sw = warp_sum(s);
    const float mw = sw * warp_rcp<T, NV>(wv);
    const float qw = warp_sum(chan_q(q, c, m, mw));
    if (lane == 0) red[warp] = make_float4(sw, mw, qw, cw);
    __syncthreads();
    // the row's (lanes past the last warp hold an empty part)
    const float4 p = part < warps ? red[part] : make_float4(0.f, 0.f, 0.f, 0.f);
    mean = group_sum(p.x, span) * inv_d;
    rsig = rsqrtf(group_sum(chan_q(p.z, p.w, p.y, mean), span) * inv_d + eps);
  }

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float gv[V], bv[V];
      Vec<T>::unpack(gr[i], gv);
      if (!RMS) Vec<T>::unpack(br[i], bv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[i][j] = RMS ? v[i][j] * rsig * gv[j]
                      : (v[i][j] - mean) * rsig * gv[j] + bv[j];
      Vec<T>::store(y + base + c * V, v[i]);
    }
  }
}

// Launch the one-wave forward at the plan's (threads, vecs), refused with
// cudaErrorInvalidValue unless that is the kernel's own configuration for
// a row of d values (wave_vecs vectors a thread, the fewest whole warps
// that cover the row with them).  a and t_out are read and written only
// with ADD.
template <typename T, bool RMS, bool ADD>
int launch_wave(const void* x, const void* a, const void* g, const void* b,
                void* t_out, void* y, int rows, int d, float eps, int threads,
                int vecs, void* stream) {
  const int nvec = d / Vec<T>::N;
  if (d > kMaxWidth || vecs != wave_vecs(nvec) ||
      threads != wave_threads(nvec, vecs))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = norm_wave_kernel<T, 1, RMS, ADD>;
  if (vecs == 2) kernel = norm_wave_kernel<T, 2, RMS, ADD>;
  if constexpr (wave_max_vecs<T>() > 2) {
    if (vecs == 4) kernel = norm_wave_kernel<T, 4, RMS, ADD>;
  }
  kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(t_out), static_cast<T*>(y), d,
      1.f / static_cast<float>(d), eps);
  return static_cast<int>(cudaGetLastError());
}

// The ring backward: RMSNorm's (rms_bwd) and LayerNorm's (ln_bwd, and with
// ADD addln_bwd) at every row count.  Persistent CTAs walk the rows
// interleaved (CTA b takes rows b, b + CTAs, ...: at any moment the CTAs
// stream neighbouring rows, which measured faster than each walking a
// contiguous run), and the design takes the old kernels' chain apart.
// - Rows in flight: thread 0 keeps the rows of the next `stages` rows in
//   flight, each row one TMA bulk copy (cp.async.bulk, completing on the
//   stage's mbarrier) into a ring of shared-memory stages: x and dy, and
//   with ADD the residual's cotangent g0 (three rows a stage), so the loads
//   of later rows run under this row's arithmetic.  The plan
//   (kernels.layernorm.norm_bwd_plan) sizes the ring and the CTAs an SM
//   holds from chip_smoke.py's norm_bwd_route_ab.
// - g is read once per CTA, kept packed in registers: a thread owns the
//   same columns in every row.  LayerNorm's backward never reads b.
// - One exchange a row.  RMSNorm needs two row sums, sum(x^2) and sum(w x)
//   with w = dy g, since mean(w xhat) = rsig sum(w x) / d.  LayerNorm needs
//   four: the mean, the centred sum of squares, sum(w) and sum(w (x -
//   mean)).  They go through one warp shuffle each, the warps' partials
//   through shared memory, one barrier, and every warp combines the
//   partials by the same shuffles (group_sum, lane l taking warp l's), so
//   every thread gets the same bits on every run.  LayerNorm's parts (a
//   thread's values, then a warp's) each carry (count c, mean m, q =
//   sum((x - m)^2), B = sum(w), A = sum(w (x - m))), centred on their own
//   mean so that nothing cancels (rows of 300 +- 3 keep their digits), and
//   combine by the k-part merge of norm_wave_kernel (chan_q, chan_a): q =
//   sum[q_k + c_k (m_k - m)^2], sum(w (x - m)) = sum[A_k + (m_k - m) B_k].
//   Then RMS: rsig = rsqrt(sum(x^2) / d + eps), m2 = rsig sum(w x) / d,
//   xhat = x rsig, dx = (w - xhat m2) rsig; LN: rsig = rsqrt(q / d + eps),
//   m1 = sum(w) / d, m2 = rsig sum(w (x - mean)) / d, xhat = (x - mean)
//   rsig, dx = (w - m1 - xhat m2) rsig; ADD: dx = round_T(dx) + g0, rounded
//   again (two roundings, as _addln_bwd_kernel).  dx is stored from
//   registers.  Nothing divides: 1/d comes from the host, a part's 1/c from
//   part_rcp / warp_rcp.
// - One barrier a row: the exchange scratch is double-buffered (row k
//   writes red[k & 1]; a thread writes it again only after the barrier of
//   row k + 1, by which every thread has read it), and the barrier also
//   frees the row's stage (every thread has copied its vectors, g0's too,
//   to registers before it), so thread 0 refills that stage with the row
//   `stages` ahead right after it.
// - The dg (and LN's db) partial rows stay in registers and are written
//   once per CTA as f32 partial rows; ring_sum_kernel, launched next, sums
//   the partial rows in a fixed order (no atomics: the same bits every run)
//   and writes dg (and db) in g's dtype: one short launch where the
//   caller's sum and cast were two PyTorch kernels, whose cost beside a
//   20-80 us ring was large enough to matter.
// - The row's columns are spread as in norm_bwd_kernel (row_shape: at
//   most kMaxThreads threads; 512-thread CTAs measured no faster on the
//   H100).  Small rows take several CTAs an SM, so that other CTAs' rows
//   overlap each CTA's per-row chain (the plan's table, from
//   chip_smoke.py's norm_bwd_route_ab).
// addrms_bwd (RMS with ADD) keeps norm_bwd_kernel.
// Bound: bytes (x, dy and g0 read once, dx written once).
constexpr int kRingMaxStages = 8;

template <typename T, int NV, bool RMS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
norm_ring_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ dy, const T* __restrict__ g0,
                     T* __restrict__ dx, float* __restrict__ dgp, float* __restrict__ dbp,
                     int rows, int d, int stages, float inv_d, float eps) {
  static_assert(!(RMS && ADD), "addrms_bwd keeps norm_bwd_kernel");
  constexpr int V = Vec<T>::N;
  constexpr int kRows = ADD ? 3 : 2;  // the rows a stage holds: x, dy (, g0)
  using Raw = typename Vec<T>::Raw;
  extern __shared__ __align__(16) unsigned char ring[];  // stages x [x | dy (| g0)]
  __shared__ __align__(8) uint64_t full[kRingMaxStages];
  // each warp's partials, two rows apart: RMS (sum x^2, sum w x); LN (sum
  // x, mean), (centred sum of squares, count), (sum w, sum w (x - mean))
  __shared__ float2 red[2][32][RMS ? 1 : 3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int span = rowwise::warp_span(warps);
  const int part = lane & (span - 1);  // the warp whose partials this lane takes
  const int nvec = d / V;
  const unsigned row_bytes = static_cast<unsigned>(d) * sizeof(T);
  // this CTA's rows: blockIdx.x, + gridDim.x, ... (n of them)
  const int b = blockIdx.x, ctas = gridDim.x;
  const int n = (rows - b + ctas - 1) / ctas;
  auto row_of = [&](int k) { return b + k * ctas; };
  const unsigned ring0 = sm90::smem_addr(ring);
  const unsigned bar0 = sm90::smem_addr(full);

  // the CTA's k-th row into stage k % stages (thread 0 only)
  auto issue = [&](int k) {
    const int st = k % stages;
    const size_t off = static_cast<size_t>(row_of(k)) * d;
    const unsigned dst = ring0 + st * kRows * row_bytes;
    sm90::mbar_expect_tx(bar0 + 8 * st, kRows * row_bytes);
    sm90::bulk_load(dst, x + off, row_bytes, bar0 + 8 * st);
    sm90::bulk_load(dst + row_bytes, dy + off, row_bytes, bar0 + 8 * st);
    if (ADD) sm90::bulk_load(dst + 2 * row_bytes, g0 + off, row_bytes, bar0 + 8 * st);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) sm90::mbar_init(bar0 + 8 * st, 1);
    sm90::mbar_init_fence();
    for (int k = 0; k < min(stages, n); ++k) issue(k);
  }

  Raw gr[NV];
  float dg[NV][V], db[RMS ? 1 : NV][V];
  int held = 0;  // this thread's vectors of the row
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      gr[i] = Vec<T>::fetch(g + c * V);
      ++held;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      dg[i][j] = 0.f;
      if constexpr (!RMS) db[i][j] = 0.f;
    }
  }
  // LN: this thread's and this warp's counts and their means' reciprocals,
  // the same in every row
  const float c_t = static_cast<float>(held * V);
  const float rcp_t = part_rcp<T, NV>(held);
  const int wv = warp_vecs<NV>(nvec, blockDim.x, warp);
  const float c_w = static_cast<float>(wv * V);
  const float rcp_w = warp_rcp<T, NV>(wv);
  __syncthreads();  // the barriers' inits, before any thread waits on them

  for (int k = 0; k < n; ++k) {
    const int st = k % stages;
    sm90::mbar_wait(bar0 + 8 * st, (k / stages) & 1);
    const T* xs = reinterpret_cast<const T*>(ring + st * kRows * row_bytes);
    const T* ds = xs + d;
    float xv[NV][V], dv[NV][V];
    Raw g0r[ADD ? NV : 1];
    float2* r = red[k & 1][warp];
    if constexpr (RMS) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = threadIdx.x + i * blockDim.x;
        if (c < nvec) {
          float gv[V];
          Vec<T>::load(xs + c * V, xv[i]);
          Vec<T>::load(ds + c * V, dv[i]);
          Vec<T>::unpack(gr[i], gv);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s0 += xv[i][j] * xv[i][j];
            s1 += dv[i][j] * gv[j] * xv[i][j];
          }
        }
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      if (lane == 0) r[0] = make_float2(s0, s1);
    } else {
      // this thread's part: the mean, then the centred sums about it
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = threadIdx.x + i * blockDim.x;
        if (c < nvec) {
          Vec<T>::load(xs + c * V, xv[i]);
          Vec<T>::load(ds + c * V, dv[i]);
          if constexpr (ADD) g0r[i] = Vec<T>::fetch(ds + d + c * V);
#pragma unroll
          for (int j = 0; j < V; ++j) s += xv[i][j];
        }
      }
      const float m = s * rcp_t;
      float q = 0.f, bs = 0.f, as = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i < held) {
          float gv[V];
          Vec<T>::unpack(gr[i], gv);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float e = xv[i][j] - m;
            const float w = dv[i][j] * gv[j];
            q += e * e;
            bs += w;
            as += w * e;
          }
        }
      }
      // the warp's part, merged onto its own mean
      const float sw = warp_sum(s);
      const float mw = sw * rcp_w;
      const float qw = warp_sum(chan_q(q, c_t, m, mw));
      const float bw = warp_sum(bs);
      const float aw = warp_sum(chan_a(as, bs, m, mw));
      if (lane == 0) {
        r[0] = make_float2(sw, mw);
        r[1] = make_float2(qw, c_w);
        r[2] = make_float2(bw, aw);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && k + stages < n) issue(k + stages);
    const float2* p = red[k & 1][part];
    const bool in = part < warps;  // lanes past the last warp hold an empty part
    float rsig, mean = 0.f, m1 = 0.f, m2;
    if constexpr (RMS) {
      const float2 p0 = in ? p[0] : make_float2(0.f, 0.f);
      rsig = rsqrtf(group_sum(p0.x, span) * inv_d + eps);
      m2 = rsig * (group_sum(p0.y, span) * inv_d);
    } else {
      const float2 p0 = in ? p[0] : make_float2(0.f, 0.f);
      const float2 p1 = in ? p[1] : make_float2(0.f, 0.f);
      const float2 p2 = in ? p[2] : make_float2(0.f, 0.f);
      mean = group_sum(p0.x, span) * inv_d;
      rsig = rsqrtf(group_sum(chan_q(p1.x, p1.y, p0.y, mean), span) * inv_d + eps);
      m1 = group_sum(p2.x, span) * inv_d;
      m2 = rsig * (group_sum(chan_a(p2.y, p2.x, p0.y, mean), span) * inv_d);
    }
    const size_t base = static_cast<size_t>(row_of(k)) * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) {
        float gv[V], o[V];
        Vec<T>::unpack(gr[i], gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if constexpr (RMS) {
            const float xh = xv[i][j] * rsig;
            o[j] = (dv[i][j] * gv[j] - xh * m2) * rsig;
            dg[i][j] += dv[i][j] * xh;
          } else {
            const float xh = (xv[i][j] - mean) * rsig;
            o[j] = (dv[i][j] * gv[j] - m1 - xh * m2) * rsig;
            dg[i][j] += dv[i][j] * xh;
            db[i][j] += dv[i][j];
          }
        }
        if constexpr (ADD) {
          float g0v[V];
          Vec<T>::unpack(g0r[i], g0v);
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = Vec<T>::round(o[j]) + g0v[j];
        }
        Vec<T>::store(dx + base + c * V, o);
      }
    }
  }

  // this CTA's partial rows: each column has one owner thread
  const size_t pbase = static_cast<size_t>(b) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        Vec<float>::store(dgp + pbase + c * V + j, &dg[i][j]);
        if constexpr (!RMS) Vec<float>::store(dbp + pbase + c * V + j, &db[i][j]);
      }
    }
  }
}

// dg (blockIdx.y 0) and LN's db (blockIdx.y 1) = the column sums of the `p`
// f32 partial rows of d values in dgp (dbp), rounded once to T.  A CTA
// takes 32 columns, a lane one column (each warp's loads of a row are one
// 128-byte line); warp w sums rows w, w + kSumWarps, ... in order, and
// warp 0 adds the warps' sums in warp order.  RMS and ADD say which
// backward the launch serves (the profiles tell them apart by them).
constexpr int kSumWarps = 16;

template <typename T, bool RMS, bool ADD>
__global__ void __launch_bounds__(kSumWarps * 32)
ring_sum_kernel(const float* __restrict__ dgp, const float* __restrict__ dbp,
                T* __restrict__ dg, T* __restrict__ db, int p, int d) {
  __shared__ float red[kSumWarps][32];
  const float* parts = RMS || blockIdx.y == 0 ? dgp : dbp;
  T* out = RMS || blockIdx.y == 0 ? dg : db;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int r = warp; r < p; r += kSumWarps) s += parts[static_cast<size_t>(r) * d + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += red[w][lane];
    rowwise::put(out + c, t);
  }
}

// Launch norm_ring_bwd_kernel over `ctas` CTAs with a ring of `stages`, at
// the plan's (threads, vecs), refused with cudaErrorInvalidValue unless
// those are row_shape's for a row of d values and the stages fit; then
// ring_sum_kernel from its `ctas` partial rows (dgp, and LN's dbp) into dg
// (and db).  g0 is read with ADD only, dbp and db without RMS only.
template <typename T, bool RMS, bool ADD, int NV = 1>
int launch_ring(const void* x, const void* g, const void* dy, const void* g0, void* dx,
                void* dgp, void* dbp, void* dg, void* db, int rows, int d, int ctas,
                int threads, int vecs, int stages, float eps, void* stream) {
  if constexpr (NV > max_nv<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    int nv, th;
    row_shape(d / Vec<T>::N, &nv, &th);
    if (nv > NV)
      return launch_ring<T, RMS, ADD, 2 * NV>(x, g, dy, g0, dx, dgp, dbp, dg, db, rows, d,
                                              ctas, threads, vecs, stages, eps, stream);
    if (d > kMaxWidth || vecs != nv || threads != th || stages < 1 ||
        stages > kRingMaxStages || ctas < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = stages * (ADD ? 3 : 2) * d * static_cast<int>(sizeof(T));
    auto kernel = norm_ring_bwd_kernel<T, NV, RMS, ADD>;
    // past 48 KB with the static scratch (under 2 KB) only by the attribute
    if (smem + 2048 > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) {
        cudaGetLastError();  // a refused attribute stays the last error
        return static_cast<int>(err);
      }
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    kernel<<<ctas, threads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(dy),
        static_cast<const T*>(g0), static_cast<T*>(dx), static_cast<float*>(dgp),
        static_cast<float*>(dbp), rows, d, stages, 1.f / static_cast<float>(d), eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ring_sum_kernel<T, RMS, ADD><<<dim3((d + 31) / 32, RMS ? 1 : 2), kSumWarps * 32, 0, st>>>(
        static_cast<const float*>(dgp), static_cast<const float*>(dbp), static_cast<T*>(dg),
        static_cast<T*>(db), ctas, d);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace rowblock
