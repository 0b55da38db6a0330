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
// element: bound by bytes.  One CTA per (slot, kv head) walking its pages
// in turn (the first kernel, kept below) left the card idle: 16-64
// CTAs on 132 SMs, no copy in flight while a CTA computed, and each score a
// dependent chain of hd FMAs.  The design:
//   - split L: the S CTAs of one thread-block cluster (grid (S, kv, B),
//     S = 1..16 by kernels.paged.paged_plan, from shapes only) share one
//     (slot, kv head).  CTA s walks pages [s n / S, (s + 1) n / S) of the
//     slot's n = min(maxp, max(pos, 0) / PAGE + 1) with the online softmax
//     above, so its partial (m_s, l_s, acc_s) is today's arithmetic over its
//     pages; a split with no page holds (-1e30, 0, 0);
//   - the combine, in f32 and in rank order, through distributed shared
//     memory: each CTA stores m_s and l_s into every peer and slice r of
//     acc_s into CTA r (st.shared::cluster), and after the cluster barrier
//     CTA r writes its slice of out = sum_s acc_s e^(m_s - m) / sum_s l_s
//     e^(m_s - m), m = max_s m_s.  No atomics, no workspace, one launch, the
//     same bits on every run.  A split whose keys are all masked (a window
//     band, a dead slot's page 0) holds m_s = -1e30 and a sum of exp(0)
//     terms, which e^(m_s - m) zeroes, since the slot's last page holds its
//     own position; a dead slot (pos < 0) reads page 0 only, all masked,
//     and gets the mean of its V rows, never NaN;
//   - the ring: the page walk is a sequence of quarter pages (32 rows of K,
//     four per page, then the page's four of V, each one contiguous block
//     of the pool), copied by the TMA (cp.async.bulk, one thread, one
//     mbarrier per stage) into a ring of 2-8 stages of 32 KB in all (64 KB
//     for f32 at head dim 256: two stages), so that the next quarter pages
//     are in flight while one is used.  A small ring keeps several CTAs on
//     an SM, and whole clusters schedulable: a first cut with half-page
//     stages and a 96 KB ring made the card hold 62 clusters of 4 where 64
//     were launched (chip_smoke.py's decode_split_ab), and ran 22.7 -> 29.0
//     us at 8 slots x 8 heads x 8 pages;
//   - no dependent chains: a key's score is split over 8-32 lanes (one
//     16-byte vector of the row each, two partial sums, a shuffle tree), the
//     lanes holding their query elements in registers; in the PV each thread
//     owns one 16-byte column vector of V and a class of keys, with one
//     accumulator per (query row, element), and the classes are summed
//     through the freed ring at the end;
//   - query rows (the group's g heads) in blocks of 1, 2, 4 or 8 (the
//     template's RB); more than 8 walk the pages again per block.
// Head dims 64, 128 and 256 are instantiated, f32 and bf16.
//
// Built with -DDECODE_ATTN_ONE_CTA, the entry launches that first kernel
// instead (chip_smoke.py's decode_attn_route_ab): one CTA of 4 warps
// per (slot, kv head) over padded shared-memory tiles, thread j scoring key
// j, an f32 accumulator in shared memory; at f32 and hd 256 its K and V
// tiles share one buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int PAGE = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A runtime call's error code for the wrapper, cleared from the runtime's
// last error, which the next launch's cudaGetLastError would report again
inline int refused(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

#ifdef DECODE_ATTN_ONE_CTA
namespace one_cta {

constexpr int kThreads = 128;  // one thread per key of a page
constexpr int kWarps = kThreads / 32;

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
    if (e != cudaSuccess) return refused(e);
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

}  // namespace one_cta
#else

namespace split {

using namespace sm90;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int KC = 32;                 // keys per ring stage: a quarter page
constexpr int kParts = PAGE / KC;      // stages of K (then of V) per page
constexpr int kRingBytes = 32 * 1024;  // the ring's budget

template <typename T, int HD>
struct Cfg {
  static constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
  static constexpr int VPR = HD / EPV;                          // vectors per cache row
  static constexpr int KL = VPR < 32 ? VPR : 32;                // lanes per key (scores)
  static constexpr int VPL = VPR / KL;                          // vectors per lane and key
  static constexpr int KPP = kThreads / KL;                     // keys per pass (scores)
  static constexpr int KS = kThreads / VPR;                     // key classes (PV)
  static constexpr int kStage = KC * HD * static_cast<int>(sizeof(T));
  static constexpr int NST = kRingBytes / kStage > 8   ? 8
                             : kRingBytes / kStage < 2 ? 2
                                                       : kRingBytes / kStage;
  static_assert(kThreads % VPR == 0 && KC % KPP == 0 && KC % KS == 0, "thread layouts");
  // the key classes' partials of 8 query rows fit the freed ring
  static_assert(KS * 8 * HD * 4 <= NST * kStage, "the PV reduction within the ring");
};

// Shared memory: the ring, the receive buffer [RB * HD], the scores
// [RB][PAGE], m, l and alpha [RB], the peers' m and l [S][RB] each, then
// the stages' mbarriers (kernels/paged.py paged_plan states the same sum)
template <typename T, int HD, int RB>
constexpr int smem_bytes(int splits) {
  using C = Cfg<T, HD>;
  return C::NST * C::kStage + (4 * (RB * (HD + PAGE + 3) + 2 * splits * RB) + 7) / 8 * 8
         + 8 * C::NST;
}

// Tile t of a CTA's walk of pages [pg0, ..) (per page kParts stages of K,
// then kParts of V) into stage u % NST of the ring by the TMA
template <typename T, int HD, int NST>
__device__ __forceinline__ void issue_tile(const T* pool_k, const T* pool_v, const int* tab,
                                           int pg0, int kvh, int h, int t, int u,
                                           unsigned ring, unsigned bars) {
  constexpr int kStage = KC * HD * static_cast<int>(sizeof(T));
  const int part = t % (2 * kParts);
  const size_t row =
      (static_cast<size_t>(tab[pg0 + t / (2 * kParts)]) * kvh + h) * PAGE + (part % kParts) * KC;
  const unsigned bar = bars + 8 * (u % NST);
  mbar_expect_tx(bar, kStage);
  bulk_load(ring + (u % NST) * kStage, (part < kParts ? pool_k : pool_v) + row * HD, kStage,
            bar);
}

// threadIdx.x read afresh: what the combine derives from it is not hoisted
// above the page walk, where the compiler kept such shared-memory addresses
// live across the walk and spilled them
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) f[i] = to_f(e[i]);
}

template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kThreads, 1)
paged_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v, const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out, int kvh, int g,
                        int maxp, float scale, int window, int sinks) {
  using C = Cfg<T, HD>;
  constexpr int EPV = C::EPV, KL = C::KL, VPL = C::VPL, KS = C::KS, NST = C::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = gridDim.x, s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  T* ring = reinterpret_cast<T*>(smem);
  float* recv = reinterpret_cast<float*>(smem + NST * C::kStage);  // [S][RB * HD / S]
  float* pr = recv + RB * HD;    // [RB][PAGE]: scores, then p
  float* mrow = pr + RB * PAGE;  // running max
  float* lrow = mrow + RB;       // running normaliser
  float* arow = lrow + RB;       // this page's rescale
  float* xm = arow + RB;         // [S][RB]: each split's m
  float* xl = xm + S * RB;       // [S][RB]: each split's l
  const unsigned bars = (smem_addr(xl + S * RB) + 7) & ~7u;
  const unsigned ring_s = smem_addr(ring);

  if (tid < NST) mbar_init(bars + 8 * tid, 1);
  mbar_init_fence();
  __syncthreads();
  if (S > 1) cluster_arrive_relaxed();  // this CTA's shared memory is there for its peers

  const int p = pos[b];
  const int n = min(maxp, max(p, 0) / PAGE + 1);
  const int pg0 = s * n / S, pg1 = (s + 1) * n / S;
  const int tiles = 2 * kParts * (pg1 - pg0);  // per page: K's stages, then V's
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* tab = table + static_cast<size_t>(b) * maxp;

  const int kl = tid % KL, kq = tid / KL;          // scores: lane of the key, key of the pass
  const int cv = tid % C::VPR, kc = tid / C::VPR;  // PV: column vector, key class
  int used = 0;
  for (int r0 = 0; r0 < g; r0 += RB) {
    const int nr = min(RB, g - r0);
    const T* qb = q + (bh * g + r0) * HD;
    float qr[RB][VPL * EPV];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (r < nr) raw = __ldg(reinterpret_cast<const uint4*>(qb + r * HD + (kl + KL * i) * EPV));
        unpack16<T>(raw, qr[r] + i * EPV);
      }
    float acc[RB][EPV];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc[r][e] = 0.f;
    if (tid < RB) {
      mrow[tid] = kNegInf;
      lrow[tid] = 0.f;
    }
    if (tid == 0)
      for (int t = 0; t < NST - 1 && t < tiles; ++t)
        issue_tile<T, HD, NST>(pool_k, pool_v, tab, pg0, kvh, h, t, used + t, ring_s, bars);

    for (int t = 0; t < tiles; ++t) {
      const int u = used + t, part = t % (2 * kParts);
      __syncthreads();  // tile t - 1's stage is free; a page's p and alpha are written
      if (tid == 0 && t + NST - 1 < tiles)
        issue_tile<T, HD, NST>(pool_k, pool_v, tab, pg0, kvh, h, t + NST - 1, u + NST - 1,
                               ring_s, bars);
      mbar_wait(bars + 8 * (u % NST), (u / NST) & 1);
      const T* tile = ring + (u % NST) * KC * HD;
      if (part < kParts) {
        // scores of the stage's keys: KL lanes per key
        const int lbase = (pg0 + t / (2 * kParts)) * PAGE + part * KC;
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += C::KPP) {
          const int k = k0 + kq;
          float kf[VPL * EPV];
#pragma unroll
          for (int i = 0; i < VPL; ++i)
            unpack16<T>(*reinterpret_cast<const uint4*>(tile + k * HD + (kl + KL * i) * EPV),
                        kf + i * EPV);
          float sc[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float a0 = 0.f, a1 = 0.f;
#pragma unroll
            for (int j = 0; j < VPL * EPV; j += 2) {
              a0 = fmaf(qr[r][j], kf[j], a0);
              a1 = fmaf(qr[r][j + 1], kf[j + 1], a1);
            }
            sc[r] = a0 + a1;
          }
#pragma unroll
          for (int off = KL / 2; off > 0; off >>= 1)
#pragma unroll
            for (int r = 0; r < RB; ++r) sc[r] += __shfl_xor_sync(kFull, sc[r], off);
          if (kl == 0) {
            const int l = lbase + k;
            bool visible = l <= p;
            if (window > 0) visible = visible && (l > p - window || l < sinks);
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (r < nr) pr[r * PAGE + part * KC + k] = visible ? sc[r] * scale : kNegInf;
          }
        }
        if (part == kParts - 1) {
          __syncthreads();
          // the page's online softmax statistics, one warp per query row
          for (int r = warp; r < nr; r += kWarps) {
            float* row = pr + r * PAGE;
            float v[PAGE / 32];
            float mx = kNegInf;
#pragma unroll
            for (int i = 0; i < PAGE / 32; ++i) {
              v[i] = row[lane + 32 * i];
              mx = fmaxf(mx, v[i]);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
            const float m_cur = mrow[r];
            const float m_new = fmaxf(m_cur, mx);
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < PAGE / 32; ++i) {
              const float e = expf(v[i] - m_new);
              sum += e;
              row[lane + 32 * i] = to_f(from_f<T>(e));  // rounded to the pool dtype
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
            if (lane == 0) {
              const float alpha = expf(m_cur - m_new);
              lrow[r] = lrow[r] * alpha + sum;
              mrow[r] = m_new;
              arow[r] = alpha;
            }
          }
        }
      } else {
        // acc = acc * alpha + p . V over the stage's keys of this class
        if (part == kParts) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float alpha = r < nr ? arow[r] : 1.f;
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[r][e] *= alpha;
          }
        }
        const float* pp = pr + (part - kParts) * KC;
#pragma unroll
        for (int k = kc; k < KC; k += KS) {
          float vf[EPV];
          unpack16<T>(*reinterpret_cast<const uint4*>(tile + k * HD + cv * EPV), vf);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < nr) {
              const float pk = pp[r * PAGE + k];
#pragma unroll
              for (int e = 0; e < EPV; ++e) acc[r][e] = fmaf(pk, vf[e], acc[r][e]);
            }
          }
        }
      }
    }
    used += tiles;
    __syncthreads();  // every tile is used: the ring takes the key classes' partials
    const int ft = fresh_tid();
    float* red = reinterpret_cast<float*>(smem);  // [KS][RB][HD]
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < EPV; ++e) red[(kc * RB + r) * HD + cv * EPV + e] = acc[r][e];
    fence_proxy_async();  // before the next block's copies into the ring
    __syncthreads();

    const int T_ = nr * HD;
    T* ob = out + (bh * g + r0) * HD;
    if (S == 1) {
      for (int i = ft; i < T_; i += kThreads) {
        const int r = i / HD, d = i % HD;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < KS; ++c) sum += red[(c * RB + r) * HD + d];
        ob[i] = from_f<T>(sum / lrow[r]);
      }
    } else {
      const int slice = T_ / S;
      if (r0 == 0) cluster_wait();  // every peer has started
      for (int i = ft; i < S * nr; i += kThreads) {
        const unsigned j = i / nr;
        const int r = i % nr;
        st_cluster(cluster_map(smem_addr(xm + s * RB + r), j), mrow[r]);
        st_cluster(cluster_map(smem_addr(xl + s * RB + r), j), lrow[r]);
      }
      for (int i = 4 * ft; i < T_; i += 4 * kThreads) {
        const int r = i / HD, d = i % HD;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          const float4 a = *reinterpret_cast<const float4*>(red + (c * RB + r) * HD + d);
          v.x += a.x;
          v.y += a.y;
          v.z += a.z;
          v.w += a.w;
        }
        const int owner = i / slice;
        st_cluster4(cluster_map(smem_addr(recv + s * slice + i - owner * slice), owner), v);
      }
      cluster_barrier();
      // this CTA's slice of the output: the splits in rank order
      for (int k = 4 * ft; k < slice; k += 4 * kThreads) {
        const int i = s * slice + k, r = i / HD;
        float m = kNegInf;
        for (int j = 0; j < S; ++j) m = fmaxf(m, xm[j * RB + r]);
        float l = 0.f;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < S; ++j) {
          const float w = expf(xm[j * RB + r] - m);
          const float4 a = *reinterpret_cast<const float4*>(recv + j * slice + k);
          l += xl[j * RB + r] * w;
          o.x += a.x * w;
          o.y += a.y * w;
          o.z += a.z * w;
          o.w += a.w * w;
        }
        ob[i] = from_f<T>(o.x / l);
        ob[i + 1] = from_f<T>(o.y / l);
        ob[i + 2] = from_f<T>(o.z / l);
        ob[i + 3] = from_f<T>(o.w / l);
      }
      if (r0 + RB < g) cluster_barrier();  // the receive buffers are read before reuse
    }
    __syncthreads();
  }
}

// the kernel's attributes, once per device: the block's shared memory, and
// clusters of up to 16 CTAs (the H100's non-portable size)
template <typename T, int HD, int RB>
cudaError_t configure() {
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(configured >> dev & 1u))) {
    auto kernel = paged_attn_split_kernel<T, HD, RB>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T, HD, RB>(16));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
  }
  return err;
}

// The launch, or with `clusters` the count of whole clusters the card can
// hold at once (cudaOccupancyMaxActiveClusters) written there instead.
// `smem` is the plan's (kernels/paged.py paged_plan), held to the kernel's.
template <typename T, int HD, int RB>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* pos, void* out, int b, int kvh, int g, int maxp, float scale,
           int window, int sinks, int splits, int smem, int* clusters, cudaStream_t st) {
  if (splits < 1 || splits > 16 || (splits & (splits - 1)) || smem != smem_bytes<T, HD, RB>(splits))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure<T, HD, RB>();
  if (err != cudaSuccess) return refused(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config(dim3(splits, kvh, b), kThreads, smem, st, attr);
  auto kernel = paged_attn_split_kernel<T, HD, RB>;
  if (clusters)
    return refused(
        cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg));
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(pk),
                           static_cast<const T*>(pv), static_cast<const int*>(table),
                           static_cast<const int*>(pos), static_cast<T*>(out), kvh, g, maxp,
                           scale, window, sinks);
  if (err != cudaSuccess) return refused(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rows(const void* q, const void* pk, const void* pv, const void* table, const void* pos,
            void* out, int b, int kvh, int g, int maxp, float scale, int window, int sinks,
            int rows, int splits, int smem, int* clusters, cudaStream_t st) {
  if (rows == 1)
    return launch<T, HD, 1>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                            splits, smem, clusters, st);
  if (rows == 2)
    return launch<T, HD, 2>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                            splits, smem, clusters, st);
  if (rows == 4)
    return launch<T, HD, 4>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                            splits, smem, clusters, st);
  if (rows == 8)
    return launch<T, HD, 8>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                            splits, smem, clusters, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int hd, const void* q, const void* pk, const void* pv, const void* table,
             const void* pos, void* out, int b, int kvh, int g, int maxp, float scale,
             int window, int sinks, int rows, int splits, int smem, int* clusters,
             cudaStream_t st) {
  if (hd == 128)
    return by_rows<T, 128>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                           rows, splits, smem, clusters, st);
  if (hd == 64)
    return by_rows<T, 64>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                          rows, splits, smem, clusters, st);
  if (hd == 256)
    return by_rows<T, 256>(q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window, sinks,
                           rows, splits, smem, clusters, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace split
#endif

}  // namespace

// The kernel on the launch plan of kernels/paged.py paged_plan: `rows`
// query rows per block (1, 2, 4 or 8), `splits` CTAs per (slot, kv head)
// and `smem` bytes of shared memory each (ignored by the
// -DDECODE_ATTN_ONE_CTA build).
extern "C" int paged_attn(const void* q, const void* pk, const void* pv,
                          const void* table, const void* pos, void* out, int b,
                          int kvh, int g, int hd, int maxp, float scale, int window,
                          int sinks, int rows, int splits, int smem, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef DECODE_ATTN_ONE_CTA
  (void)rows, (void)splits, (void)smem;
  if (dtype == 1)
    return one_cta::dispatch<__nv_bfloat16>(hd, q, pk, pv, table, pos, out, b, kvh, g, maxp,
                                            scale, window, sinks, st);
  return one_cta::dispatch<float>(hd, q, pk, pv, table, pos, out, b, kvh, g, maxp, scale,
                                  window, sinks, st);
#else
  if (dtype == 1)
    return split::dispatch<__nv_bfloat16>(hd, q, pk, pv, table, pos, out, b, kvh, g, maxp,
                                          scale, window, sinks, rows, splits, smem, nullptr, st);
  return split::dispatch<float>(hd, q, pk, pv, table, pos, out, b, kvh, g, maxp, scale, window,
                                sinks, rows, splits, smem, nullptr, st);
#endif
}

// How many clusters of the plan the card holds at once (into *clusters),
// for chip_smoke.py's split A/B; an error code where the plan is refused.
extern "C" int paged_attn_clusters(int g, int hd, int rows, int splits, int smem, int dtype,
                                   int* clusters) {
#ifdef DECODE_ATTN_ONE_CTA
  (void)g, (void)hd, (void)rows, (void)splits, (void)smem, (void)dtype, (void)clusters;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (dtype == 1)
    return split::dispatch<__nv_bfloat16>(hd, nullptr, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, 1, 1, g, 1, 1.f, 0, 0, rows, splits, smem,
                                          clusters, 0);
  return split::dispatch<float>(hd, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1,
                                g, 1, 1.f, 0, 0, rows, splits, smem, clusters, 0);
#endif
}
