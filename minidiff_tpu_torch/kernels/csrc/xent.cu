// Softmax cross-entropy over integer labels, forward and backward, for
// sm_90a.
//
// Replaces minidiff_tpu/kernels/xent.py:
//   xent_fwd <- _fwd_kernel (:64, pallas_call in _pallas_xent_fwd :89)
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
// 5 flops and one exp per element, far under the ridge.
//
// The warp kernels (xent_fwd_kernel, xent_bwd_kernel), for the rows the row
// kernel below does not take: one warp per row (4 rows a CTA), lanes on
// neighbouring 16-byte vectors, a pass over the row for its max, one for its
// sum of exps and, in the backward, one for the output.  Each pass reads the
// row again.  That costs little at V = 512 (a 1 KB bf16 row stays in L1
// between passes) and everything at the options step's V = 32,768: a 64 KB
// row does not stay in L1, and with a warp per row thousands of rows are in
// flight at once, hundreds of MB of logits against the 50 MB L2, so each
// pass reads device memory again.  The forward then loads z[label] once
// more, a dependent load after both passes.  A row that is no whole number
// of 16-byte vectors (V = 10 in the tape's MLP) is read one element per lane
// instead, so any V works.
//
// The row kernel (xent_row_kernel<T, NV, BWD>; kernels.xent.xent_fwd_plan
// and xent_bwd_plan send rows of whole vectors to it, by V, before launch):
// one CTA per row, of up to kRowMaxThreads threads, holds its row on chip,
// so the logits cross device memory once (and the backward's dz once).
// - One load wave: every thread fetches its NV 16-byte vectors of the row
//   (vector t, t + threads, ...), kept packed as loaded, with the row's
//   label (and the backward's cotangent), before any arithmetic.
// - Each thread takes the max m_t of its own values, then their exps
//   e_i = exp(z_i - m_t) in f32, summed into s_t: one exp per element.  The
//   forward keeps no e_i; the thread whose vectors hold column `label` takes
//   z[label] from its registers while it takes m_t (a compare against each
//   column, no indexed register and no load after the exchange).
// - One exchange: each warp merges its lanes' (m_t, s_t) into
//   (m_w = max m_t, s_w = sum s_t exp(m_t - m_w)) by shuffles, writes it to
//   shared memory, one barrier, and every warp merges the warps' pairs the
//   same way (lane l taking warp l's), so every thread gets the same m and
//   s, and the same bits on every run.
// - Forward: loss = (log(s) + m) - z[label], written by the label's holder,
//   or by thread 0 with z[label] = 0 for a label outside [0, V).
// - Backward: dz_i = (e_i c_t - [i == label]) g with c_t = exp(m_t - m) / s:
//   the division is one approximate reciprocal of s per thread (s >= 1: the
//   element at the row's max contributes exp(0)); the kernel divides
//   nowhere else (a division's slow-path call is what made ptxas spill the
//   norm kernels).  One 16-byte store per vector.
// Exps issued: one per element, and two (forward) or three (backward) per
// thread: V + 3 x threads a row in the backward, 1.09 per element at V
// 32,768 on 1,024 threads, where the warp kernels issue two per element.
// The backward holds its row as f32 in registers: at most kRowMaxValues
// values a thread (64 registers at 1,024 threads), so V up to 32,768 in
// either dtype; wider rows keep the warp kernels.  The forward holds it
// packed, at most kFwdMaxVecs vectors a thread: at V 32,768 in bf16, 512
// threads of 8 vectors (32 registers of logits), so that two rows fit an
// SM and one's loads overlap the other's exps (at 1,024 threads of 4
// vectors, one row an SM loaded, then computed).  A build with -DXENT_FWD_V1
// sends every forward row, and one with -DXENT_BWD_V1 every backward row,
// to the warp (or one-element) kernel, as before the row kernel
// (chip_smoke.py times the two in turns).

#include "rowwise.cuh"

namespace {

using rowwise::group_max;
using rowwise::group_sum;
using rowwise::put;
using rowwise::Vec;
using rowwise::warp_max;
using rowwise::warp_sum;

#ifdef XENT_BWD_V1
constexpr bool kBwdV1 = true;
#else
constexpr bool kBwdV1 = false;
#endif
#ifdef XENT_FWD_V1
constexpr bool kFwdV1 = true;
#else
constexpr bool kFwdV1 = false;
#endif

constexpr int kWarpsPerBlock = 4;
// the row kernel's widest CTA, the most values (f32 registers) a thread
// of the backward holds (at 1,024 threads a thread has 64 registers), and
// the most 16-byte vectors a thread of the forward holds (packed: 32
// registers)
constexpr int kRowMaxThreads = 1024;
constexpr int kRowMaxValues = 32;
constexpr int kFwdMaxVecs = 8;

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

// One CTA per row (see the header): the forward (BWD false) writes the
// row's loss, the backward its dz.  NV vectors a thread: vector c of the row
// is held by thread c % blockDim.x; every warp holds at least one.
template <typename T, int NV, bool BWD>
__global__ void __launch_bounds__(kRowMaxThreads)
xent_row_kernel(const T* __restrict__ z, const int* __restrict__ lab,
                const float* __restrict__ g, T* __restrict__ dz,
                float* __restrict__ loss, int v) {
  constexpr int W = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
  // each warp's (m_w, s_w)
  __shared__ float2 red[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int span = rowwise::warp_span(warps);
  const int part = lane & (span - 1);  // the warp whose pair this lane takes
  const int nvec = v / W;
  const size_t base = static_cast<size_t>(blockIdx.x) * v;

  Raw zr[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) zr[i] = Vec<T>::fetch(z + base + c * W);
  }
  const int l = lab[blockIdx.x];
  const float gr = BWD ? g[blockIdx.x] : 0.f;

  // the backward keeps its values (then its exps) in f32; the forward
  // unpacks the packed row again for the exps, which halves its registers
  float e[BWD ? NV : 1][W];
  float mt = -3.402823466e38f;
  float zl = 0.f;     // the forward's z[label], if this thread holds it
  bool mine = false;  // whether it does
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float x[W];
      Vec<T>::unpack(zr[i], x);
      const int lj = l - c * W;  // the label's place in this vector, if any
#pragma unroll
      for (int j = 0; j < W; ++j) {
        mt = fmaxf(mt, x[j]);
        if constexpr (BWD) {
          e[i][j] = x[j];
        } else if (j == lj) {
          zl = x[j];
          mine = true;
        }
      }
    }
  }
  float st = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (threadIdx.x + i * blockDim.x < nvec) {
      float x[W];
      if constexpr (BWD) {
#pragma unroll
        for (int j = 0; j < W; ++j) x[j] = e[i][j];
      } else {
        Vec<T>::unpack(zr[i], x);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        x[j] = expf(x[j] - mt);
        if constexpr (BWD) e[i][j] = x[j];
        st += x[j];
      }
    }
  }

  // the exchange: a lane that holds nothing has s_t = 0 and adds 0
  const float mw = warp_max(mt);
  const float sw = warp_sum(st * expf(mt - mw));
  if (lane == 0) red[warp] = make_float2(mw, sw);
  __syncthreads();
  const float2 p = part < warps ? red[part] : make_float2(-3.402823466e38f, 0.f);
  const float m = group_max(p.x, span);
  const float s = group_sum(p.y * expf(p.x - m), span);

  if constexpr (!BWD) {
    // the label's holder writes; thread 0 where no thread holds it
    if (mine || (threadIdx.x == 0 && (l < 0 || l >= v)))
      loss[blockIdx.x] = (logf(s) + m) - zl;
  } else {
    float rs;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rs) : "f"(s));
    const float ct = expf(mt - m) * rs;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) {
        const int lj = l - c * W;
        float o[W];
#pragma unroll
        for (int j = 0; j < W; ++j) o[j] = (e[i][j] * ct - (j == lj ? 1.f : 0.f)) * gr;
        Vec<T>::store(dz + base + c * W, o);
      }
    }
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

// The row kernel's launch for the plan's (threads, vecs), or nullptr unless
// they are a configuration it takes for a row of v values: whole vectors,
// vecs in {1, 2, 4, 8} with at most kRowMaxValues values a thread, and the
// fewest whole warps, at most kRowMaxThreads threads, that cover the row.
template <typename T, bool BWD>
auto row_kernel(int v, int threads, int vecs) -> decltype(&xent_row_kernel<T, 1, BWD>) {
  constexpr int W = Vec<T>::N;
  constexpr int kMaxVecs = BWD ? kRowMaxValues / W : kFwdMaxVecs;
  const int nvec = v / W;
  if (v % W || vecs > kMaxVecs || threads % 32 || threads > kRowMaxThreads ||
      threads * vecs < nvec || (threads - 32) * vecs >= nvec)
    return nullptr;
  if (vecs == 1) return xent_row_kernel<T, 1, BWD>;
  if (vecs == 2) return xent_row_kernel<T, 2, BWD>;
  if (vecs == 4) return xent_row_kernel<T, 4, BWD>;
  if constexpr (kMaxVecs >= 8) {
    if (vecs == 8) return xent_row_kernel<T, 8, BWD>;
  }
  return nullptr;
}

// vecs > 0: the row kernel at (threads, vecs), refused with
// cudaErrorInvalidValue unless row_kernel takes them; 0 (and every row of a
// -DXENT_FWD_V1 build): the warp kernel, or one element a lane for rows
// that are no whole number of vectors.
template <typename T>
cudaError_t launch_fwd(const void* z, const int* lab, float* loss, int rows, int v,
                       int threads, int vecs, cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  if (vecs > 0 && !kFwdV1) {
    auto kernel = row_kernel<T, false>(v, threads, vecs);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    kernel<<<rows, threads, 0, st>>>(zt, lab, nullptr, nullptr, loss, v);
  } else if (vector_rows<T>(v, z, z)) {
    xent_fwd_kernel<T, true><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, loss, rows, v);
  } else {
    xent_fwd_kernel<T, false><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, loss, rows, v);
  }
  return cudaGetLastError();
}

// vecs > 0: the row kernel at (threads, vecs), refused with
// cudaErrorInvalidValue unless row_kernel takes them; 0 (and every row of a
// -DXENT_BWD_V1 build): the warp kernel, or one element a lane for rows
// that are no whole number of vectors.
template <typename T>
cudaError_t launch_bwd(const void* z, const int* lab, const float* g, void* dz,
                       int rows, int v, int threads, int vecs, cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  T* dzt = static_cast<T*>(dz);
  if (vecs > 0 && !kBwdV1) {
    auto kernel = row_kernel<T, true>(v, threads, vecs);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    kernel<<<rows, threads, 0, st>>>(zt, lab, g, dzt, nullptr, v);
  } else if (vector_rows<T>(v, z, dz)) {
    xent_bwd_kernel<T, true><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, g, dzt, rows, v);
  } else {
    xent_bwd_kernel<T, false><<<blocks_for(rows), kWarpsPerBlock * 32, 0, st>>>(
        zt, lab, g, dzt, rows, v);
  }
  return cudaGetLastError();
}

}  // namespace

// z (rows, v) contiguous, any v; lab (rows,) int32; loss (rows,) f32.
// dtype: 0 = float32, 1 = bfloat16.  threads, vecs: the launch plan's
// (kernels.xent.xent_fwd_plan); vecs > 0 takes the row kernel (refused
// unless they are a configuration it takes), 0 the warp kernel, as does
// every row of a -DXENT_FWD_V1 build.  Returns cudaGetLastError().
extern "C" int xent_fwd(const void* z, const void* lab, void* loss, int rows,
                        int v, int dtype, int threads, int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lab);
  float* out = static_cast<float*>(loss);
  if (dtype == 1)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(z, lb, out, rows, v, threads, vecs, st));
  return static_cast<int>(launch_fwd<float>(z, lb, out, rows, v, threads, vecs, st));
}

// g (rows,) f32, the cotangent of each row's loss; dz like z.  threads,
// vecs: the launch plan's (kernels.xent.xent_bwd_plan); vecs > 0 takes the
// row kernel (refused unless they are a configuration it takes), 0 the warp
// kernel, as does every row of a -DXENT_BWD_V1 build.
extern "C" int xent_bwd(const void* z, const void* lab, const void* g,
                        void* dz, int rows, int v, int dtype, int threads,
                        int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lab);
  const float* gr = static_cast<const float*>(g);
  if (dtype == 1)
    return static_cast<int>(
        launch_bwd<__nv_bfloat16>(z, lb, gr, dz, rows, v, threads, vecs, st));
  return static_cast<int>(launch_bwd<float>(z, lb, gr, dz, rows, v, threads, vecs, st));
}
