// Flash-attention backward for sm_90a: dq, dk, dv from q, k, v, dO and the
// forward's per-row logsumexp, without the (S, S) score matrix reaching HBM.
//
// Replaces minidiff_tpu/kernels/attention.py, reached through _flash_bwd
// (:434):
//   flash_bwd_dkv <- _bwd_dkv_kernel (:339, pallas_call at :464)
//   flash_bwd_dq  <- _bwd_dq_kernel  (:390, pallas_call at :505)
// Same contract (_recompute_p_ds :309): s = (q k^T) * scale in f32, masked
// to -1e30 (so P is exactly 0 there); P = exp(s - lse) from the saved lse;
// dP = dO v^T; dS = P * (dP - delta) * scale with delta = rowsum(dO * o),
// which the caller computes.  P and dS round to the operand dtype before
// the products dV += P^T dO, dK += dS^T q and dQ = dS k (f32 accumulation),
// as :369, :373 and :416 cast them.  Causal tiles with no visible pair are
// skipped (_block_live).  Like the JAX pair the two kernels are
// deterministic: dK/dV and dQ each have one owner block, no atomics.  Ragged
// S is masked by bounds instead of padded.
//
// Bound on the H100: at the train step's (64, 1024, 128) causal bf16 the
// operations (8 S*Sk*D per head for the two kernels' five products of which
// four are distinct, halved by causality) over the 989 TFLOP/s bf16 rate
// exceed the bytes (q, k, v, dO, dq, dk, dv, lse, delta once each) over
// 3.35 TB/s: a perfect kernel is bound by the tensor cores.  This simple one
// is bound by its shared-memory round trips and WMMA's rate, and by one
// 4-warp block per SM (its tiles take ~190 KB of shared memory).
//
// Design (at D 128; D 256 below).  dkv: one block per (batch*head, 64-key
// tile); it keeps its K and V tiles and f32 dK/dV accumulators in shared
// memory and walks the live 64-query tiles.  Each warp owns 16 KEY rows and computes the TRANSPOSED
// scores S^T = K Q^T and dP^T = V dO^T for them, so that P^T and dS^T come
// out row-major for its own rows and the products P^T dO and dS^T Q read dO
// and Q in their stored layout: no transposed tile is ever loaded.  dq: one
// block per (batch*head, 64-query tile), warps own 16 query rows, walking
// the live key tiles; dQ += dS K.  Because P comes straight from the saved
// lse there is no running max, so the fragment-ownership problem of the
// forward's online softmax does not arise: S and dP pass through shared
// memory once per tile, and every step after a tile load touches only the
// warp's own rows (warp barriers only).  bf16 uses WMMA 16x16x16 with f32
// accumulation; f32 stays on the CUDA cores (TF32 would break the f32
// contract).  Head dims 128 and 256 are the two instantiations, as
// _flash_eligible takes them.  At D 256 the tiles are 32 rows (BT), where
// 64-row ones would need 322 KB (bf16) of the 227 KB a block may use: the
// 4 warps then pair up on each 16-row group, splitting the columns of every
// product between them, and the element step's rows span both warps of a
// pair, so its warp barriers become block barriers.  wgmma, TMA and
// register-resident accumulators are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps

// Shared-memory row strides (elements) of one instantiation, head dim D and
// tiles of BT rows.  "C" tiles are the column operand of a score product
// (lanes walk their rows in the f32 loop, so f32 pads to D + 1 for distinct
// banks); "R" tiles are the row operand.  bf16 strides are multiples of 8
// as WMMA asks.  In f32, P and dS overwrite the f32 score buffers in place
// (LDP == LDS, no separate buffers).
template <typename T, int D, int BT> struct Layout;
template <int D, int BT> struct Layout<__nv_bfloat16, D, BT> {
  static constexpr int LDC = D + 8, LDR = D + 8, LDS = BT + 4, LDP = BT + 8,
                       LDO = D + 4;
  static constexpr bool kSeparateP = true;
};
template <int D, int BT> struct Layout<float, D, BT> {
  static constexpr int LDC = D + 1, LDR = D, LDS = BT + 1, LDP = BT + 1,
                       LDO = D;
  static constexpr bool kSeparateP = false;
};

// How the 4 warps share a BT-row tile: BT / 16 groups of 16 rows, CW warps
// on each group, warp `cs` of a group taking the cs-th share of the columns
// of every product.
template <int BT> struct Warps {
  static constexpr int CW = 4 / (BT / 16);
  __device__ static int group(int warp) { return warp / CW; }
  __device__ static int share(int warp) { return warp % CW; }
  // the barrier between steps whose rows cross warps: a warp's own when
  // each warp owns its rows, the block's when two warps share them
  __device__ static void sync() {
    if (CW == 1) __syncwarp(); else __syncthreads();
  }
};

// Shared-memory carve-up of one block: `acc` f32 accumulators (2 for dkv,
// 1 for dq), two f32 score buffers, two row-operand and two column-operand
// tiles, the P/dS buffers (bf16 only), then lse and delta.  Accumulators
// first keeps every WMMA pointer 32-byte aligned.
template <typename T, int D, int BT>
struct Smem {
  float* acc;
  float* s;
  float* dp;
  T* r0;
  T* r1;
  T* c0;
  T* c1;
  T* p;
  T* ds;
  float* lse;
  float* delta;

  static constexpr size_t bytes(int n_acc, int n_p) {
    using L = Layout<T, D, BT>;
    return static_cast<size_t>(n_acc) * BT * L::LDO * 4 + 2ull * BT * L::LDS * 4 +
           2ull * BT * L::LDR * sizeof(T) + 2ull * BT * L::LDC * sizeof(T) +
           (L::kSeparateP ? static_cast<size_t>(n_p) * BT * L::LDP * sizeof(T) : 0) +
           2ull * BT * 4;
  }

  __device__ Smem(unsigned char* base, int n_acc, int n_p) {
    using L = Layout<T, D, BT>;
    acc = reinterpret_cast<float*>(base);
    s = acc + n_acc * BT * L::LDO;
    dp = s + BT * L::LDS;
    r0 = reinterpret_cast<T*>(dp + BT * L::LDS);
    r1 = r0 + BT * L::LDR;
    c0 = r1 + BT * L::LDR;
    c1 = c0 + BT * L::LDC;
    if (L::kSeparateP) {
      p = c1 + BT * L::LDC;
      ds = p + (n_p == 2 ? BT * L::LDP : 0);
      lse = reinterpret_cast<float*>(ds + BT * L::LDP);
    } else {
      // f32: P in the score buffer, dS in the dP buffer
      p = reinterpret_cast<T*>(s);
      ds = reinterpret_cast<T*>(dp);
      lse = reinterpret_cast<float*>(c1 + BT * L::LDC);
    }
    delta = lse + BT;
  }
};

// Copy rows [r0, r0 + BT) of a (n, D) matrix into a tile of stride ld,
// zeros past n.
template <int D, int BT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int r0,
                                          int n) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BT * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

template <int D, int BT>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < n) ? src[static_cast<size_t>(r0 + r) * D + c] : 0.f;
  }
}

// BT f32 values of a per-row vector (lse or delta), zeros past n.
template <int BT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n) {
  if (threadIdx.x < BT) dst[threadIdx.x] = (r0 + threadIdx.x < n) ? src[r0 + threadIdx.x] : 0.f;
}

// out[16 rows of this warp's group][this warp's share of BT columns] =
// A[those rows] . B[those columns' rows]^T over D, unscaled f32.  A has
// stride lda, B stride ldb, out stride LDS.
template <int D, int BT>
__device__ __forceinline__ void rows_by_cols(const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B, int ldb,
                                             float* out, int warp, int lane) {
  using W = Warps<BT>;
  constexpr int LDS = Layout<__nv_bfloat16, D, BT>::LDS;
  constexpr int NT = BT / 16 / W::CW;  // 16-column tiles per warp
  const int rg = W::group(warp);
  for (int nt = W::share(warp) * NT; nt < (W::share(warp) + 1) * NT; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + (16 * rg) * lda + 16 * kk, lda);
      // B stored (row, d) row-major is B^T in column-major
      wmma::load_matrix_sync(b, B + (16 * nt) * ldb + 16 * kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + (16 * rg) * LDS + 16 * nt, acc, LDS,
                            wmma::mem_row_major);
  }
}

// f32: lanes own columns lane + 32 j of all BT; the warps of a group split
// its 16 rows.
template <int D, int BT>
__device__ __forceinline__ void rows_by_cols(const float* A, int lda,
                                             const float* B, int ldb,
                                             float* out, int warp, int lane) {
  using W = Warps<BT>;
  constexpr int LDS = Layout<float, D, BT>::LDS;
  constexpr int RPW = 16 / W::CW;  // rows per warp
  constexpr int CPL = BT / 32;     // columns per lane
  float acc[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
  const int row0 = 16 * W::group(warp) + RPW * W::share(warp);
  const float* a = A + row0 * lda;
  for (int d = 0; d < D; ++d) {
    float bv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) bv[j] = B[(lane + 32 * j) * ldb + d];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float av = a[r * lda + d];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) out[(row0 + r) * LDS + lane + 32 * j] = acc[r][j];
}

// acc[16 rows of this warp's group][this warp's share of D] +=
// P[those rows][BT] . B[BT][that share].  P has stride LDP, B stride ldb,
// acc stride LDO.
template <int D, int BT>
__device__ __forceinline__ void acc_rows(const __nv_bfloat16* P,
                                         const __nv_bfloat16* B, int ldb,
                                         float* acc, int warp, int lane) {
  using W = Warps<BT>;
  constexpr int LDP = Layout<__nv_bfloat16, D, BT>::LDP;
  constexpr int LDO = Layout<__nv_bfloat16, D, BT>::LDO;
  constexpr int NT = D / 16 / W::CW;  // 16-column tiles per warp
  const int rg = W::group(warp);
  for (int nt = W::share(warp) * NT; nt < (W::share(warp) + 1) * NT; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    float* o = acc + (16 * rg) * LDO + 16 * nt;
    wmma::load_matrix_sync(c, o, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, P + (16 * rg) * LDP + 16 * kk, LDP);
      wmma::load_matrix_sync(b, B + (16 * kk) * ldb + 16 * nt, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(o, c, LDO, wmma::mem_row_major);
  }
}

template <int D, int BT>
__device__ __forceinline__ void acc_rows(const float* P, const float* B,
                                         int ldb, float* acc, int warp,
                                         int lane) {
  using W = Warps<BT>;
  constexpr int LDP = Layout<float, D, BT>::LDP;
  constexpr int LDO = Layout<float, D, BT>::LDO;
  constexpr int JW = D / 32 / W::CW;  // 32-column strips per warp
  const int rg = W::group(warp);
  const int c0 = lane + 32 * JW * W::share(warp);
  for (int r = 0; r < 16; ++r) {
    const float* p = P + (16 * rg + r) * LDP;
    float s[JW];
#pragma unroll
    for (int j = 0; j < JW; ++j) s[j] = 0.f;
    for (int k = 0; k < BT; ++k) {
      const float pk = p[k];
#pragma unroll
      for (int j = 0; j < JW; ++j) s[j] = fmaf(pk, B[k * ldb + c0 + 32 * j], s[j]);
    }
    float* o = acc + (16 * rg + r) * LDO;
#pragma unroll
    for (int j = 0; j < JW; ++j) o[c0 + 32 * j] += s[j];
  }
}

__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

// Whether key tile kt holds any (row, col) pair visible to query tile qt
// (tiles of BT rows each).
template <int BT>
__device__ __forceinline__ bool tile_live(int qt, int kt, int causal,
                                          int window) {
  if (!causal) return true;
  const bool causal_live = kt * BT <= qt * BT + BT - 1;
  if (window <= 0) return causal_live;
  return causal_live && (kt * BT + BT - 1 >= qt * BT - (window - 1));
}

__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk,
                                        int causal, int window) {
  bool keep = qi < sq && kj < sk;
  if (causal) {
    keep = keep && qi >= kj;
    if (window > 0) keep = keep && (qi - kj < window);
  }
  return keep;
}

// Write rows [r0, r0 + BT) of an f32 accumulator tile to a (n, D) output,
// rows past n dropped.
template <typename T, int D, int BT>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, int r0,
                                           int n) {
  constexpr int LDO = Layout<T, D, BT>::LDO;
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (r0 + r < n) put(dst + static_cast<size_t>(r0 + r) * D + c, acc[r * LDO + c]);
  }
}

// The element step's split: TPR threads per tile row, CPT columns each
// (two lanes of 32 columns at BT 64, four threads of 8 at BT 32).
template <int BT> struct Elems {
  static constexpr int TPR = kThreads / BT, CPT = BT / TPR;
};

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, float scale,
                     int causal, int window) {
  using L = Layout<T, D, BT>;
  using W = Warps<BT>;
  using E = Elems<BT>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, D, BT> sm(smem, 2, 2);
  float* sdK = sm.acc;
  float* sdV = sm.acc + BT * L::LDO;
  T* sK = sm.r0;
  T* sV = sm.r1;
  T* sQ = sm.c0;
  T* sdO = sm.c1;

  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* dob = dout + static_cast<size_t>(bh) * sq * D;
  const float* lseb = lse + static_cast<size_t>(bh) * sq;
  const float* deltab = delta + static_cast<size_t>(bh) * sq;

  load_rows<D, BT>(sK, L::LDR, k + static_cast<size_t>(bh) * sk * D, k0, sk);
  load_rows<D, BT>(sV, L::LDR, v + static_cast<size_t>(bh) * sk * D, k0, sk);
  for (int i = threadIdx.x; i < 2 * BT * L::LDO; i += kThreads) sm.acc[i] = 0.f;

  // element work: E::TPR threads per (key) row, E::CPT query columns each
  const int srow = threadIdx.x / E::TPR;
  const int cbase = E::CPT * (threadIdx.x % E::TPR);
  const int kj = k0 + srow;

  const int n_qt = (sq + BT - 1) / BT;
  for (int qt = 0; qt < n_qt; ++qt) {
    if (!tile_live<BT>(qt, kt, causal, window)) continue;
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's Q, dO, lse and delta consumed
    load_rows<D, BT>(sQ, L::LDC, qb, q0, sq);
    load_rows<D, BT>(sdO, L::LDC, dob, q0, sq);
    load_vec<BT>(sm.lse, lseb, q0, sq);
    load_vec<BT>(sm.delta, deltab, q0, sq);
    __syncthreads();

    rows_by_cols<D, BT>(sK, L::LDR, sQ, L::LDC, sm.s, warp, lane);    // S^T
    rows_by_cols<D, BT>(sV, L::LDR, sdO, L::LDC, sm.dp, warp, lane);  // dP^T
    W::sync();
    for (int j = 0; j < E::CPT; ++j) {
      const int col = cbase + j;
      const int e = srow * L::LDS + col;
      const float p = visible(q0 + col, kj, sq, sk, causal, window)
                          ? expf(sm.s[e] * scale - sm.lse[col]) : 0.f;
      const float ds = p * (sm.dp[e] - sm.delta[col]) * scale;
      put(sm.p + srow * L::LDP + col, p);
      put(sm.ds + srow * L::LDP + col, ds);
    }
    W::sync();
    acc_rows<D, BT>(sm.p, sdO, L::LDC, sdV, warp, lane);   // dV += P^T dO
    acc_rows<D, BT>(sm.ds, sQ, L::LDC, sdK, warp, lane);   // dK += dS^T Q
    W::sync();
  }
  __syncthreads();
  store_rows<T, D, BT>(dk + static_cast<size_t>(bh) * sk * D, sdK, k0, sk);
  store_rows<T, D, BT>(dv + static_cast<size_t>(bh) * sk * D, sdV, k0, sk);
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal, int window) {
  using L = Layout<T, D, BT>;
  using W = Warps<BT>;
  using E = Elems<BT>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T, D, BT> sm(smem, 1, 1);
  float* sdQ = sm.acc;
  T* sQ = sm.r0;
  T* sdO = sm.r1;
  T* sK = sm.c0;
  T* sV = sm.c1;

  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  load_rows<D, BT>(sQ, L::LDR, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_rows<D, BT>(sdO, L::LDR, dout + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_vec<BT>(sm.lse, lse + static_cast<size_t>(bh) * sq, q0, sq);
  load_vec<BT>(sm.delta, delta + static_cast<size_t>(bh) * sq, q0, sq);
  for (int i = threadIdx.x; i < BT * L::LDO; i += kThreads) sdQ[i] = 0.f;

  // element work: E::TPR threads per (query) row, E::CPT key columns each
  const int srow = threadIdx.x / E::TPR;
  const int cbase = E::CPT * (threadIdx.x % E::TPR);
  const int qi = q0 + srow;

  const int n_kt = (sk + BT - 1) / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live<BT>(qt, kt, causal, window)) continue;
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K and V consumed
    load_rows<D, BT>(sK, L::LDC, kb, k0, sk);
    load_rows<D, BT>(sV, L::LDC, vb, k0, sk);
    __syncthreads();

    rows_by_cols<D, BT>(sQ, L::LDR, sK, L::LDC, sm.s, warp, lane);    // S
    rows_by_cols<D, BT>(sdO, L::LDR, sV, L::LDC, sm.dp, warp, lane);  // dP
    W::sync();
    const float lse_r = sm.lse[srow], delta_r = sm.delta[srow];
    for (int j = 0; j < E::CPT; ++j) {
      const int col = cbase + j;
      const int e = srow * L::LDS + col;
      const float p = visible(qi, k0 + col, sq, sk, causal, window)
                          ? expf(sm.s[e] * scale - lse_r) : 0.f;
      put(sm.ds + srow * L::LDP + col, p * (sm.dp[e] - delta_r) * scale);
    }
    W::sync();
    acc_rows<D, BT>(sm.ds, sK, L::LDC, sdQ, warp, lane);  // dQ += dS K
    W::sync();
  }
  __syncthreads();
  store_rows<T, D, BT>(dq + static_cast<size_t>(bh) * sq * D, sdQ, q0, sq);
}

template <typename T, int D, int BT>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int bh, int sq, int sk, float scale, int causal, int window,
           bool dkv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (dkv) {
    constexpr size_t bytes = Smem<T, D, BT>::bytes(2, 2);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sk + BT - 1) / BT, bh);
    flash_bwd_dkv_kernel<T, D, BT><<<grid, kThreads, bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, sk, scale, causal, window);
  } else {
    constexpr size_t bytes = Smem<T, D, BT>::bytes(1, 1);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + BT - 1) / BT, bh);
    flash_bwd_dq_kernel<T, D, BT><<<grid, kThreads, bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), sq, sk, scale,
        causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for head dim d: 64-row tiles at 128, 32 at 256.
template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta, void* dq,
             void* dk, void* dv, int bh, int sq, int sk, float scale,
             int causal, int window, bool dkv, void* stream) {
  if (d == 128)
    return launch<T, 128, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk,
                              scale, causal, window, dkv, stream);
  if (d == 256)
    return launch<T, 256, 32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk,
                              scale, causal, window, dkv, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q and dout (bh, sq, d), k and v (bh, sk, d), lse and delta (bh, sq) f32;
// dk, dv like k; d 128 or 256; all contiguous and 16-byte aligned.  dtype:
// 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.  Returns
// cudaGetLastError().
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, float scale, int causal,
                             int window, int dtype, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, dout, l, dl, nullptr, dk, dv, bh,
                                   sq, sk, scale, causal, window, true, stream);
  return dispatch<float>(d, q, k, v, dout, l, dl, nullptr, dk, dv, bh, sq, sk,
                         scale, causal, window, true, stream);
}

// dq like q; the other operands as for flash_bwd_dkv.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, float scale, int causal, int window,
                            int dtype, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, dout, l, dl, dq, nullptr, nullptr,
                                   bh, sq, sk, scale, causal, window, false, stream);
  return dispatch<float>(d, q, k, v, dout, l, dl, dq, nullptr, nullptr, bh, sq,
                         sk, scale, causal, window, false, stream);
}
