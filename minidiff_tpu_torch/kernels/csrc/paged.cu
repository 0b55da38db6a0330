// Paged decode attention for sm_90a: one query token per slot over a shared
// pool of 128-token KV pages, read through the slot's page table.
//
// Replaces minidiff_tpu/kernels/paged.py _make_kernel (:64, pallas_call at
// :140).  Same contract: for each page pg = 0 .. max(pos, 0) / PAGE of a
// slot (pages past it are never read), scores (q . k) * scale in f32, masked
// to l <= pos (and, with a window, l > pos - window or l < sinks) with
// -1e30; an online softmax carries the running max m, the normaliser l (a
// sum of the unrounded f32 probabilities) and an f32 accumulator; each
// page's probabilities exp(s - m_new) are rounded to the pool dtype before
// the PV product, and the output is acc / l in q's dtype.  q must already be
// in the pools' dtype (the server casts it, as the JAX step does).
//
// Bound on the H100: a decode step reads each live page of K and V once,
// 2 * 128 * hd elements per (slot, kv head, page), and does 4 flop per
// element: bound by bytes.  Design: one CTA of 4 warps per (slot, kv head)
// walks the slot's pages; each page's K and V tiles are copied into padded
// shared-memory rows with 16-byte loads (hd + 8 bf16 or hd + 4 f32 per row,
// so that the per-key dot products of neighbouring threads hit distinct
// banks); thread j scores key j for every query head of the group, one warp
// per query head takes the page's max and sum, and the threads then own the
// (head, d) outputs of the PV product, whose f32 accumulator stays in shared
// memory.  Head dims 64, 128 and 256 are instantiated.  At f32 and hd 256
// the K and V tiles of a page would take 266 KB of the 227 KB a block may
// use, so there they share one buffer: V is loaded into it after the scores
// are taken, while the warps run the softmax statistics.  Double-buffered
// tiles (cp.async or TMA) and splitting a long slot over several CTAs are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAGE = 128;
constexpr int kThreads = 128;  // one thread per key of a page
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// elements per 16-byte vector, and the padded row stride of a page tile
template <typename T> __host__ __device__ constexpr int epv() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T, int HD> __host__ __device__ constexpr int tile_ld() { return HD + epv<T>(); }

// q . row over HD elements, the row in shared memory, read 16 bytes at a time
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const float* qrow, const T* krow) {
  constexpr int EPV = epv<T>();
  float acc = 0.f;
#pragma unroll 4
  for (int d0 = 0; d0 < HD; d0 += EPV) {
    uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < EPV; ++i) acc = fmaf(qrow[d0 + i], to_f(e[i]), acc);
  }
  return acc;
}

// whether K and V share one page tile (f32 at hd 256)
template <typename T, int HD> __host__ __device__ constexpr bool one_tile() {
  return 2ull * PAGE * tile_ld<T, HD>() * sizeof(T) > 160 * 1024;
}

template <typename T, int HD>
size_t smem_bytes(int g) {
  return (one_tile<T, HD>() ? 1ull : 2ull) * PAGE * tile_ld<T, HD>() * sizeof(T)
         + (2ull * g * HD + static_cast<size_t>(g) * PAGE + 3ull * g) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v, const int* __restrict__ table,
                  const int* __restrict__ pos, T* __restrict__ out, int kvh, int g,
                  int maxp, float scale, int window, int sinks) {
  constexpr int LD = tile_ld<T, HD>();
  constexpr int EPV = epv<T>();
  constexpr int VPR = HD / EPV;  // 16-byte vectors per cache row
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kOneTile = one_tile<T, HD>();
  T* ks = reinterpret_cast<T*>(smem);          // (PAGE, LD)
  T* vs = kOneTile ? ks : ks + PAGE * LD;      // (PAGE, LD)
  float* qs = reinterpret_cast<float*>(vs + PAGE * LD);  // (g, HD)
  float* pr = qs + g * HD;                      // (g, PAGE) scores, then p
  float* acc = pr + g * PAGE;                   // (g, HD)
  float* mrow = acc + g * HD;                   // (g,) running max
  float* lrow = mrow + g;                       // (g,) running normaliser
  float* arow = lrow + g;                       // (g,) this page's rescale

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = pos[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;

  for (int i = tid; i < g * HD; i += kThreads) {
    qs[i] = to_f(q[bh * g * HD + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
  }

  for (int pg = 0; pg < maxp && pg * PAGE <= p; ++pg) {
    const int pid = table[static_cast<size_t>(b) * maxp + pg];
    const size_t base = (static_cast<size_t>(pid) * kvh + h) * PAGE * HD;
    __syncthreads();  // the previous page's tiles and probabilities are used
    for (int i = tid; i < PAGE * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * EPV;
      *reinterpret_cast<uint4*>(ks + r * LD + c) =
          __ldg(reinterpret_cast<const uint4*>(pool_k + base + static_cast<size_t>(r) * HD + c));
      if (!kOneTile)
        *reinterpret_cast<uint4*>(vs + r * LD + c) =
            __ldg(reinterpret_cast<const uint4*>(pool_v + base + static_cast<size_t>(r) * HD + c));
    }
    __syncthreads();

    // scores: thread tid scores key tid for every query head of the group
    const int l = pg * PAGE + tid;
    bool visible = l <= p;
    if (window > 0) visible = visible && (l > p - window || l < sinks);
    for (int gi = 0; gi < g; ++gi) {
      const float sc = dot_row<T, HD>(qs + gi * HD, ks + tid * LD) * scale;
      pr[gi * PAGE + tid] = visible ? sc : kNegInf;
    }
    __syncthreads();

    // one shared tile: every score is taken, so V may overwrite K
    if (kOneTile)
      for (int i = tid; i < PAGE * VPR; i += kThreads) {
        const int r = i / VPR, c = (i % VPR) * EPV;
        *reinterpret_cast<uint4*>(vs + r * LD + c) =
            __ldg(reinterpret_cast<const uint4*>(pool_v + base + static_cast<size_t>(r) * HD + c));
      }

    // online softmax statistics, one warp per query head
    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = pr + gi * PAGE;
      float v[PAGE / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < PAGE / 32; ++t) {
        v[t] = row[lane + 32 * t];
        mx = fmaxf(mx, v[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_cur = mrow[gi];
      const float m_new = fmaxf(m_cur, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < PAGE / 32; ++t) {
        const float e = expf(v[t] - m_new);
        sum += e;
        row[lane + 32 * t] = to_f(from_f<T>(e));  // rounded to the pool dtype
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_cur - m_new);
        lrow[gi] = lrow[gi] * alpha + sum;
        mrow[gi] = m_new;
        arow[gi] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V, one (head, d) output per thread and pass
    for (int o = tid; o < g * HD; o += kThreads) {
      const int gi = o / HD, d = o % HD;
      const float* prow = pr + gi * PAGE;
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < PAGE; ++j) sum = fmaf(prow[j], to_f(vs[j * LD + d]), sum);
      acc[o] = acc[o] * arow[gi] + sum;
    }
  }
  __syncthreads();
  for (int o = tid; o < g * HD; o += kThreads)
    out[bh * g * HD + o] = from_f<T>(acc[o] / lrow[o / HD]);
}

template <typename T, int HD>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* pos, void* out, int b, int kvh, int g, int maxp, float scale,
           int window, int sinks, cudaStream_t st) {
  const size_t smem = smem_bytes<T, HD>(g);
  auto kernel = paged_attn_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(kvh, b), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<T*>(out),
      kvh, g, maxp, scale, window, sinks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* pk, const void* pv, const void* table,
             const void* pos, void* out, int b, int kvh, int g, int maxp, float scale,
             int window, int sinks, cudaStream_t st) {
  if (hd == 128)
    return launch<T, 128>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks, st);
  if (hd == 64)
    return launch<T, 64>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks, st);
  if (hd == 256)
    return launch<T, 256>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int paged_attn(const void* q, const void* pk, const void* pv,
                          const void* table, const void* pos, void* out, int b,
                          int kvh, int g, int hd, int maxp, float scale, int window,
                          int sinks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, pk, pv, table, pos, out, b, kvh, g, maxp,
                                   scale, window, sinks, st);
  return dispatch<float>(hd, q, pk, pv, table, pos, out, b, kvh, g, maxp, scale,
                         window, sinks, st);
}
