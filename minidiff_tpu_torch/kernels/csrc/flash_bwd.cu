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
// as :369, :373 and :416 cast them.  Causal and window tiles with no
// visible pair are skipped (_block_live).  Like the JAX pair the two
// kernels are deterministic: dK/dV and dQ each have one owner CTA, no
// atomics.  Ragged S is masked by bounds instead of padded.
//
// Bound on the H100: at the train step's (64, 1024, 128) causal bf16 the
// operations (8 S*Sk*D per head for dK/dV's four products, 6 for dQ's
// three, halved by causality) over the 989 TFLOP/s bf16 rate exceed the
// bytes (q, k, v, dO, dq, dk, dv, lse, delta once each) over 3.35 TB/s: a
// perfect kernel is bound by the tensor cores.
//
// bf16 (namespace wg) runs on wgmma.  Each kernel's CTA is one or two
// consumer warpgroups and one producer warpgroup (kernels/attention.py
// flash_bwd_plan decides the count, from shapes, before launch):
//   - flash_bwd_dkv owns one (batch*head, key tile): K and V are loaded once
//     into 128-byte-swizzled shared memory; the producer streams the live
//     query tiles' Q and dO (64 rows) and their lse and delta through a ring
//     of cp.async stages (three at head dim 128, two at 256) guarded by
//     mbarriers, rows past Sq zero-filled.  A consumer computes S^T = K Q^T
//     and dP^T = V dO^T (Q and dO K-major B operands: no transposed tile is
//     stored), forms P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T -
//     delta) scale in registers, and accumulates dV += P^T dO, dK += dS^T Q
//     with P^T and dS^T as register A operands in the accumulator's layout
//     and dO, Q as MN-major B operands of the same stage.  At head dim 128
//     each warpgroup owns 64 keys (128 or 64 per CTA); at 256, where dK and
//     dV of 64 keys would need 256 f32 registers a thread, the two
//     warpgroups own the same 64 keys and 128 columns each: both compute
//     the whole S^T and dP^T (1.5x the products of one owner), and no tile
//     crosses between them;
//   - flash_bwd_dq owns one (batch*head, query tile of 64 rows per
//     warpgroup): Q and dO resident, lse and delta in registers; the
//     producer streams the live K and V tiles (64 keys); S = Q K^T and dP =
//     dO V^T (K, V K-major B), dS in registers, dQ += dS K (dS the register
//     A operand, K the MN-major B); dQ (64 x D f32) stays in registers;
//   - every accumulator lives in registers until the epilogue: shared
//     memory carries no S, P, dS or accumulator tile; setmaxnreg moves the
//     producer's registers to two consumers (40 / 232, but 24 / 240 in
//     dK/dV at head dim 128, whose consumers spilled at 232: the producer's
//     copies are slower at 24 elsewhere);
//   - each warpgroup issues two MMA bursts per tile (the score products,
//     then the accumulating ones) and waits for each before it touches
//     their registers (no register defined while a group is partly
//     retired: ptxas C7513); two consumers take turns at issuing (named
//     barriers), two turns per tile of the CTA whether or not the tile is
//     live for the warpgroup's rows, so that one's element step runs beside
//     the other's MMAs and neither can stall the ring;
//   - masks only on tiles that reach past Sq / Sk, the diagonal or a window
//     edge; the longest causal columns (dK/dV) and rows (dQ) first.
// f32 keeps the CUDA-core tile below (TF32 would break the f32 contract).
// Built with -DFLASH_BWD_WMMA_BF16, bf16 runs that tile's WMMA form instead
// (chip_smoke.py's A/B of the two).
//
// The masks beyond causal and the window (flash_mask.cuh): attention sinks
// (the dQ kernel streams the sink tiles below its band first, as
// flash_fwd.cu; a dK/dV CTA holding a sink key walks every query tile
// from its diagonal on), a key-padding row and segment ids, which mask
// every tile and are compiled only into the kernels that take them
// (ROWS).  A masked pair has P = 0, and P = 1 on a row with no visible key
// (lse -1e30), as the TPU kernels' exp(-1e30 - lse).
//
// The CUDA-core / WMMA tile (at D 128; D 256 below).  dkv: one block per
// (batch*head, 64-key tile); it keeps its K and V tiles and f32 dK/dV
// accumulators in shared memory and walks the live 64-query tiles.  Each
// warp owns 16 KEY rows and computes the TRANSPOSED scores S^T = K Q^T and
// dP^T = V dO^T for them, so that P^T and dS^T come out row-major for its
// own rows and the products P^T dO and dS^T Q read dO and Q in their stored
// layout.  dq: one block per (batch*head, 64-query tile), warps own 16
// query rows, walking the live key tiles; dQ += dS K.  S and dP pass
// through shared memory once per tile, and every step after a tile load
// touches only the warp's own rows (warp barriers only).  bf16 uses WMMA
// 16x16x16 with f32 accumulation; f32 stays on the CUDA cores.  At D 256
// the tiles are 32 rows (BT), where 64-row ones would need 322 KB (bf16)
// of the 227 KB a block may use: the 4 warps then pair up on each 16-row
// group, splitting the columns of every product between them, and the
// element step's rows span both warps of a pair, so its warp barriers
// become block barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "wgmma.cuh"

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

[[maybe_unused]] __device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

// P of one (query, key) pair from its unscaled score s and the query's
// lse: exp(s scale - lse) where the pair is visible (in bounds and kept by
// the masks), else 0, or 1 on a row with no visible key (lse -1e30): the
// JAX kernels' exp(-1e30 - lse) of a masked score.
template <bool ROWS>
__device__ __forceinline__ float prob(const FlashMask& mk, int qi, int kj, int sq, int sk,
                                      int qid, float s, float scale, float lse) {
  if (qi < sq && kj < sk && mk.keep<ROWS>(qi, kj, qid)) return expf(s * scale - lse);
  return ROWS && lse == -1e30f ? 1.f : 0.f;
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

// One block per SM (its shared memory allows no more at either head dim):
// told so, ptxas stops spilling to keep registers for a second one (f32 at
// head dim 256 spilled 12 bytes)
template <typename T, int D, int BT, bool ROWS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ kvm,
                     const int* __restrict__ seg, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, float scale,
                     int causal, int window, int sinks, int h) {
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
  const FlashMask mk(causal, window, sinks, kvm, seg, bh, h, sq, sk);

  const int n_qt = (sq + BT - 1) / BT;
  for (int qt = 0; qt < n_qt; ++qt) {
    if (!mk.tile_live(qt * BT, BT, k0, BT)) continue;
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
      const float p = prob<ROWS>(mk, q0 + col, kj, sq, sk, mk.id(q0 + col, sq), sm.s[e],
                                 scale, sm.lse[col]);
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

template <typename T, int D, int BT, bool ROWS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ kvm,
                    const int* __restrict__ seg, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal, int window, int sinks, int h) {
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
  const FlashMask mk(causal, window, sinks, kvm, seg, bh, h, sq, sk);
  const int qid = mk.id(qi, sq);

  const int n_kt = (sk + BT - 1) / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!mk.tile_live(q0, BT, kt * BT, BT)) continue;
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
      const float p = prob<ROWS>(mk, qi, k0 + col, sq, sk, qid, sm.s[e], scale, lse_r);
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
           const float* lse, const float* delta, const int* kvm, const int* seg, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, float scale, int causal, int window,
           int sinks, int h, bool dkv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (dkv) {
    constexpr size_t bytes = Smem<T, D, BT>::bytes(2, 2);
    auto kernel = kvm || seg ? flash_bwd_dkv_kernel<T, D, BT, true>
                             : flash_bwd_dkv_kernel<T, D, BT, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sk + BT - 1) / BT, bh);
    kernel<<<grid, kThreads, bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, kvm, seg, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, sk, scale, causal, window, sinks, h);
  } else {
    constexpr size_t bytes = Smem<T, D, BT>::bytes(1, 1);
    auto kernel = kvm || seg ? flash_bwd_dq_kernel<T, D, BT, true>
                             : flash_bwd_dq_kernel<T, D, BT, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + BT - 1) / BT, bh);
    kernel<<<grid, kThreads, bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, kvm, seg, static_cast<T*>(dq), sq, sk, scale,
        causal, window, sinks, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for head dim d: 64-row tiles at 128, 32 at 256.
template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta, const int* kvm,
             const int* seg, void* dq, void* dk, void* dv, int bh, int sq, int sk, float scale,
             int causal, int window, int sinks, int h, bool dkv, void* stream) {
  if (d == 128)
    return launch<T, 128, 64>(q, k, v, dout, lse, delta, kvm, seg, dq, dk, dv, bh, sq, sk,
                              scale, causal, window, sinks, h, dkv, stream);
  if (d == 256)
    return launch<T, 256, 32>(q, k, v, dout, lse, delta, kvm, seg, dq, dk, dv, bh, sq, sk,
                              scale, causal, window, sinks, h, dkv, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// bf16 on wgmma
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// The MMA turns of a CTA's consumer warpgroups (named barriers 1 and 2).
// With two, their bursts alternate, warpgroup 0 first, so that one's
// element step runs beside the other's MMAs.  Each warpgroup takes every
// turn of the CTA, two per streamed tile (the score products, then the
// accumulating ones), whether or not the tile is live for its rows: a
// turn it skipped would leave the other waiting for a hand-over that comes
// only after a stage the waiter holds.  Warpgroup 1's last turn hands over
// nothing, so that every arrive is awaited.
template <int WGS>
struct Turns {
  int wgi, turns, taken;
  __device__ Turns(int wgi_, int turns_) : wgi(wgi_), turns(turns_), taken(0) {
    if (WGS == 2 && wgi == 1 && turns > 0) named_arrive(1, 256);
  }
  __device__ void mine() const {
    if constexpr (WGS == 2) named_sync(1 + wgi, 256);
  }
  __device__ void yours() {
    ++taken;
    if constexpr (WGS == 2)
      if (wgi == 0 || taken < turns) named_arrive(2 - wgi, 256);
  }
  __device__ void skip() {  // a turn with no MMA
    mine();
    yours();
  }
};

// P^T and dS^T of one tile of the dK/dV kernel, in registers.  s and dp
// hold S^T and dP^T (this warpgroup's 64 keys x BQ queries, unscaled); P^T
// = exp(s scale - lse) (base 2: exp2(s sl2 - lse log2 e)) and dS^T =
// P^T (dP^T - delta) scale leave rounded to bf16 in the accumulator's
// layout (registers 4kk.. hold queries 16kk..): the A operands of
// dV += P^T dO and dK += dS^T Q.  `st` holds the tile's lse, then its
// delta (BQ each), from this thread's first column c2 on.  MASK: pairs
// past Sq (cmax columns are in range), above the diagonal or outside the
// window (query - key = dbase + column - row) unless the key is a sink
// (kmax: rows below it are), and with ROWS pairs the key row or ids drop,
// get P = 0; with ROWS, 1 on a query row with no visible key (lse -1e30).
// ROWS: the key row kv0 / kv8 of this thread's keys (nonzero: kept), their
// ids id0 / id8 against the queries' (seg from the tile's first column).
template <int BQ, bool MASK, bool ROWS>
__device__ __forceinline__ void grads_t(const float (&s)[BQ / 2], const float (&dp)[BQ / 2],
                                        unsigned (&p)[BQ / 4], unsigned (&ds)[BQ / 4],
                                        const float* st, float sl2, float scale, int cmax,
                                        int dbase, int causal, int window, int kmax,
                                        const int* seg, const int (&kv)[2],
                                        const int (&kid)[2]) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    float pe[2][2], de[2][2];  // [row][column]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + e;
      const float l2 = st[col] * kLog2e, dl = st[BQ + col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float pv = exp2_approx(fmaf(s[i], sl2, -l2));
        if constexpr (MASK) {
          const int d = dbase + col - 8 * r;
          bool keep = col < cmax && (!causal || (d >= 0 && (window <= 0 || d < window ||
                                                           8 * r < kmax)));
          if constexpr (ROWS) {
            keep = keep && kv[r] != 0 && (seg == nullptr || seg[col] == kid[r]);
            pv = keep ? pv : (st[col] == -1e30f ? 1.f : 0.f);
          } else {
            pv = keep ? pv : 0.f;
          }
        }
        pe[r][e] = pv;
        de[r][e] = pv * (dp[i] - dl) * scale;
      }
    }
    p[2 * j] = pack_bf16(pe[0][0], pe[0][1]);
    p[2 * j + 1] = pack_bf16(pe[1][0], pe[1][1]);
    ds[2 * j] = pack_bf16(de[0][0], de[0][1]);
    ds[2 * j + 1] = pack_bf16(de[1][0], de[1][1]);
  }
}

// dS of one tile of the dQ kernel, in registers: s and dp hold S and dP
// (this warpgroup's 64 query rows x BK keys); this thread's two rows' lse
// (times log2 e) and delta are l2 and dl.  dS = P (dP - delta) scale
// leaves rounded to bf16 in the accumulator's layout, the A operand of
// dQ += dS K.  MASK: keys past Sk (cmax columns are in range), above the
// diagonal or outside the window (key - query = dbase + column - row)
// unless a sink (columns below smax are), and with ROWS the pairs the key
// row or ids drop (kvm, seg from the tile's first column; qid the rows'
// ids), get P = 0; with ROWS, 1 on a row with no visible key (dead[r]).
template <int BK, bool MASK, bool ROWS>
__device__ __forceinline__ void grads(const float (&s)[BK / 2], const float (&dp)[BK / 2],
                                      unsigned (&ds)[BK / 4], const float (&l2)[2],
                                      const float (&dl)[2], float sl2, float scale, int cmax,
                                      int dbase, int causal, int window, int smax,
                                      const int* kvm, const int* seg, const int (&qid)[2],
                                      const bool (&dead)[2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float de[2][2];  // [row][column]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e, col = 8 * j + e;
        float pv = exp2_approx(fmaf(s[i], sl2, -l2[r]));
        if constexpr (MASK) {
          const int d = dbase + col - 8 * r;
          bool keep = col < cmax && (!causal || (d <= 0 && (window <= 0 || d > -window ||
                                                           col < smax)));
          if constexpr (ROWS) {
            keep = keep && (kvm == nullptr || kvm[col] != 0) &&
                   (seg == nullptr || seg[col] == qid[r]);
            pv = keep ? pv : (dead[r] ? 1.f : 0.f);
          } else {
            pv = keep ? pv : 0.f;
          }
        }
        de[r][e] = pv * (dp[i] - dl[r]) * scale;
      }
    ds[2 * j] = pack_bf16(de[0][0], de[0][1]);
    ds[2 * j + 1] = pack_bf16(de[1][0], de[1][1]);
  }
}

// dK/dV: one instantiation of head dim D, WGS consumer warpgroups, query
// tiles of BQ rows in a ring of STAGES.  At head dim 128 each warpgroup
// owns 64 keys (KEYS = 64 WGS); at 256 the two own the same 64 keys and
// 128 columns each of dK and dV, so that neither holds more than two
// 64 x 128 f32 accumulators (both compute the whole S^T and dP^T).  Shared
// memory (after up to 1 KB that aligns it): K, V, the ring of (Q tile, dO
// tile), the ring's lse and delta, then the mbarriers.
template <int D, int WGS, int BQ, int STAGES>
struct DkvCfg {
  static constexpr bool kSplitD = D == 256;
  static_assert(!kSplitD || WGS == 2, "head dim 256 splits its columns over two warpgroups");
  static constexpr int KEYS = kSplitD ? 64 : 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kKV = KEYS * D * 2;   // K or V
  static constexpr int kQ = BQ * D * 2;      // Q or dO of one stage
  static constexpr int kRing = STAGES * 2 * kQ;
  static constexpr int kStats = 2 * BQ * 4;  // lse and delta of one stage
  static constexpr int kBars = 2 * kKV + kRing + STAGES * kStats;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * STAGES);
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(2 * BQ <= 128, "one producer thread per lse or delta value");
  // the registers of the producer and of each of two consumers: at head
  // dim 128 the consumers spilled at 232; at 256 (no spill there) the
  // producer's copies were slower at 24
  static constexpr int kProducerRegs = D == 128 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 128 ? 240 : 232;
};

template <int D, int WGS, int BQ, int STAGES, bool ROWS>
__global__ void __launch_bounds__(128 * WGS + 128, 1)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ kvm, const int* __restrict__ seg,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                           float scale, int causal, int window, int sinks, int h) {
  using C = DkvCfg<D, WGS, BQ, STAGES>;
  extern __shared__ unsigned char smem[];
  const unsigned base = smem_addr(smem);
  const unsigned sK = (base + 1023) & ~1023u, sV = sK + C::kKV, sRing = sV + C::kKV;
  const unsigned sStats = sRing + C::kRing;
  const unsigned kvbar = sK + C::kBars;  // then full[STAGES], empty[STAGES]
  auto full = [&](int n) { return kvbar + 8 + 8 * (n % STAGES); };
  auto empty = [&](int n) { return kvbar + 8 + 8 * STAGES + 8 * (n % STAGES); };
  auto stage = [&](int n) { return sRing + (n % STAGES) * 2 * C::kQ; };  // Q, then dO
  auto stats = [&](int n) { return sStats + (n % STAGES) * C::kStats; };  // lse, then delta
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * C::KEYS;  // the first keys (the longest causal columns) first

  // the live query tiles [qt0, qt0 + ntiles): causal tiles wholly above the
  // diagonal of the CTA's first key, and with a window those wholly past
  // the band of its last, are skipped; a CTA holding a sink key is live for
  // every query tile from its diagonal on
  const FlashMask mk(causal, window, sinks, kvm, seg, bh, h, sq, sk);
  int qt0 = 0, qt1 = (sq + BQ - 1) / BQ;
  if (causal) {
    qt0 = min(qt1, k0 / BQ);
    if (window > 0 && k0 >= mk.sinks)
      qt1 = min(qt1, (min(k0 + C::KEYS, sk) - 1 + window - 1) / BQ + 1);
  }
  const int ntiles = qt1 - qt0;

  if (tid == 0) {
    mbar_init(kvbar, 128);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);       // the producer warpgroup's copies landed
      mbar_init(empty(st), 4 * WGS);  // every consumer warp done with the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {
    // the producer warpgroup: K and V, then each live query tile's Q, dO,
    // lse and delta into the ring, a stage refilled once every consumer
    // warp is done with it.  Two consumers take the registers it gives up
    // (168 each at entry)
    if constexpr (WGS == 2) setmaxnreg_dec<C::kProducerRegs>();
    const int t = tid - C::kConsumers;
    load_tile<D, C::KEYS, 128>(sK, k + static_cast<size_t>(bh) * sk * D, k0, sk, t);
    load_tile<D, C::KEYS, 128>(sV, v + static_cast<size_t>(bh) * sk * D, k0, sk, t);
    mbar_arrive_cp_async(kvbar);
    const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
    const bf16* dob = dout + static_cast<size_t>(bh) * sq * D;
    const float* sb = (t < BQ ? lse : delta) + static_cast<size_t>(bh) * sq;
    for (int n = 0; n < ntiles; ++n) {
      mbar_wait(empty(n), ((n / STAGES) & 1) ^ 1);
      const int q0 = (qt0 + n) * BQ;
      load_tile<D, BQ, 128>(stage(n), qb, q0, sq, t);
      load_tile<D, BQ, 128>(stage(n) + C::kQ, dob, q0, sq, t);
      if (t < 2 * BQ) {
        const int r = q0 + t % BQ;
        cp_async4(stats(n) + 4 * t, r < sq ? sb + r : sb, r < sq ? 4 : 0);
      }
      mbar_arrive_cp_async(full(n));
    }
    cp_async_wait_all();
  } else {
    if constexpr (WGS == 2) setmaxnreg_inc<C::kConsumerRegs>();
    const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this warpgroup's keys [w0, w0 + 64) and columns [wd, wd + 128) of dK
    // and dV; this thread's keys ra, ra + 8 and first column c2 of a tile
    const int w0 = k0 + (C::kSplitD ? 0 : 64 * wgi);
    const int wd = C::kSplitD ? 128 * wgi : 0;
    const int ra = w0 + 16 * warp + lane / 4, c2 = 2 * (lane % 4);
    const unsigned wk = sK + (w0 - k0) * 128, wv = sV + (w0 - k0) * 128;
    const unsigned wcol = (wd / 64) * BQ * 128;  // its columns' atoms in a Q or dO tile
    const float* st0 = reinterpret_cast<const float*>(smem + (sStats - base)) + c2;
    const float sl2 = scale * kLog2e;
    // with ROWS, this thread's keys' entries of the key row and their ids
    int kv[2] = {1, 1}, kid[2] = {0, 0};
    if constexpr (ROWS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        kv[r] = mk.kvm != nullptr && ra + 8 * r < sk ? mk.kvm[ra + 8 * r] : 1;
        kid[r] = mk.id(ra + 8 * r, sk);
      }
    }

    // the tiles [na, nb) with a visible pair for this warpgroup's keys
    int na = 0, nb = w0 < sk ? ntiles : 0;
    if (w0 < sk && causal) {
      if (window > 0 && w0 >= mk.sinks)
        nb = min(nb, (min(w0 + 63, sk - 1) + window - 1) / BQ + 1 - qt0);
      na = min(nb, max(0, w0 / BQ - qt0));
    }
    auto acquire = [&](int n) {
      mbar_wait(full(n), (n / STAGES) & 1);
      fence_proxy_async();
    };
    auto release = [&](int n) {
      if (lane == 0) mbar_arrive(empty(n));
    };

    float dkacc[1][64], dvacc[1][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dkacc[0][i] = dvacc[0][i] = 0.f;

    Turns<WGS> turn(wgi, 2 * ntiles);
    mbar_wait(kvbar, 0);
    for (int n = 0; n < na; ++n) {
      acquire(n);
      turn.skip();
      turn.skip();
      release(n);
    }
    for (int n = na; n < nb; ++n) {
      acquire(n);
      const int q0 = (qt0 + n) * BQ;
      float s[BQ / 2], dp[BQ / 2];
      turn.mine();
      wgmma_fence();
      qk<D, BQ, C::KEYS>(s, wk, stage(n));           // S^T = K Q^T
      qk<D, BQ, C::KEYS>(dp, wv, stage(n) + C::kQ);  // dP^T = V dO^T
      wgmma_commit();
      turn.yours();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // masks only where the tile reaches past Sq, the diagonal or the
      // window's far edge for some key of this warpgroup
      unsigned p[BQ / 4], ds[BQ / 4];
      const float* st = st0 + (n % STAGES) * (C::kStats / 4);
      const int* segq = ROWS && mk.seg ? mk.seg + q0 + c2 : nullptr;
      if (q0 + BQ > sq || ROWS ||
          (causal && (q0 < w0 + 63 || (window > 0 && q0 + BQ - 1 - w0 >= window))))
        grads_t<BQ, true, ROWS>(s, dp, p, ds, st, sl2, scale, sq - q0 - c2, q0 + c2 - ra,
                                causal, window, mk.sinks - ra, segq, kv, kid);
      else
        grads_t<BQ, false, ROWS>(s, dp, p, ds, st, sl2, scale, 0, 0, causal, window, 0, segq,
                                 kv, kid);
      turn.mine();
      wgmma_fence();
      pv<128, BQ>(dvacc, p, stage(n) + C::kQ + wcol);  // dV += P^T dO
      pv<128, BQ>(dkacc, ds, stage(n) + wcol);         // dK += dS^T Q
      wgmma_commit();
      turn.yours();
      wgmma_wait<0>();
      fence_regs(dvacc[0]);
      fence_regs(dkacc[0]);
      fence_regs(p);
      fence_regs(ds);
      release(n);
    }
    for (int n = max(na, nb); n < ntiles; ++n) {
      acquire(n);
      turn.skip();
      turn.skip();
      release(n);
    }

    // keys past sk are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row < sk) {
        const size_t off = (static_cast<size_t>(bh) * sk + row) * D + wd + c2;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<unsigned*>(dk + off + 8 * j) =
              pack_bf16(dkacc[0][4 * j + 2 * r], dkacc[0][4 * j + 2 * r + 1]);
          *reinterpret_cast<unsigned*>(dv + off + 8 * j) =
              pack_bf16(dvacc[0][4 * j + 2 * r], dvacc[0][4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ: one instantiation of head dim D, WGS consumer warpgroups of 64 query
// rows each, key tiles of BK rows in a ring of STAGES.  Shared memory
// (after up to 1 KB that aligns it): Q, dO, the ring of (K tile, V tile),
// then the mbarriers.
template <int D, int WGS, int BK, int STAGES>
struct DqCfg {
  static constexpr int ROWS = 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kQ = ROWS * D * 2;  // Q or dO
  static constexpr int kKV = BK * D * 2;   // K or V of one stage
  static constexpr int kBars = 2 * kQ + STAGES * 2 * kKV;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * STAGES);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <int D, int WGS, int BK, int STAGES, bool ROWS>
__global__ void __launch_bounds__(128 * WGS + 128, 1)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ kvm, const int* __restrict__ seg,
                          bf16* __restrict__ dq, int sq, int sk, float scale, int causal,
                          int window, int sinks, int h) {
  using C = DqCfg<D, WGS, BK, STAGES>;
  extern __shared__ unsigned char smem[];
  const unsigned sQ = (smem_addr(smem) + 1023) & ~1023u, sdO = sQ + C::kQ, sKV = sdO + C::kQ;
  const unsigned qbar = sQ + C::kBars;  // then full[STAGES], empty[STAGES]
  auto full = [&](int n) { return qbar + 8 + 8 * (n % STAGES); };
  auto empty = [&](int n) { return qbar + 8 + 8 * STAGES + 8 * (n % STAGES); };
  auto stage = [&](int n) { return sKV + (n % STAGES) * 2 * C::kKV; };  // K, then V
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // the last query tiles (the longest causal rows) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::ROWS;

  // the live key tiles, as flash_fwd.cu's: the ns tiles holding sink
  // columns below the band, then [kt0, kt1)
  const FlashMask mk(causal, window, sinks, kvm, seg, bh, h, sq, sk);
  const int last = min(q0 + C::ROWS, sq) - 1;
  int kt0 = 0, kt1 = (sk + BK - 1) / BK, ns = 0;
  if (causal) {
    kt1 = min(kt1, last / BK + 1);
    if (window > 0) {
      kt0 = max(0, q0 - window + 1) / BK;
      ns = min(kt0, (mk.sinks + BK - 1) / BK);
    }
  }
  const int ntiles = ns + kt1 - kt0;
  auto key0 = [&](int n) { return (n < ns ? n : kt0 + n - ns) * BK; };

  if (tid == 0) {
    mbar_init(qbar, 128);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);
      mbar_init(empty(st), 4 * WGS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {
    // the producer warpgroup: Q and dO, then each live K/V tile (40 / 232
    // registers: at 24 its copies were slower)
    if constexpr (WGS == 2) setmaxnreg_dec<40>();
    const int t = tid - C::kConsumers;
    load_tile<D, C::ROWS, 128>(sQ, q + static_cast<size_t>(bh) * sq * D, q0, sq, t);
    load_tile<D, C::ROWS, 128>(sdO, dout + static_cast<size_t>(bh) * sq * D, q0, sq, t);
    mbar_arrive_cp_async(qbar);
    const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
    const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
    for (int n = 0; n < ntiles; ++n) {
      mbar_wait(empty(n), ((n / STAGES) & 1) ^ 1);
      load_tile<D, BK, 128>(stage(n), kb, key0(n), sk, t);
      load_tile<D, BK, 128>(stage(n) + C::kKV, vb, key0(n), sk, t);
      mbar_arrive_cp_async(full(n));
    }
    cp_async_wait_all();
  } else {
    if constexpr (WGS == 2) setmaxnreg_inc<232>();
    const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this warpgroup's rows [w0, w0 + 64); this thread's rows ra, ra + 8
    const int w0 = q0 + 64 * wgi;
    const int ra = w0 + 16 * warp + lane / 4, c2 = 2 * (lane % 4);
    const unsigned wq = sQ + wgi * 64 * 128, wdo = sdO + wgi * 64 * 128;
    const float sl2 = scale * kLog2e;
    float l2[2], dl[2];
    bool dead[2];
    const int qid[2] = {ROWS ? mk.id(ra, sq) : 0, ROWS ? mk.id(ra + 8, sq) : 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      const bool ok = row < sq;
      const float lr = ok ? lse[static_cast<size_t>(bh) * sq + row] : 0.f;
      l2[r] = lr * kLog2e;
      dead[r] = lr == -1e30f;
      dl[r] = ok ? delta[static_cast<size_t>(bh) * sq + row] : 0.f;
    }

    // the tiles [na, nb) with a visible pair for this warpgroup's rows;
    // with sinks every tile from 0 on (flash_fwd.cu's rule)
    int na = 0, nb = w0 < sq ? ntiles : 0;
    if (w0 < sq && causal) {
      nb = min(ntiles, min(w0 + 63, sq - 1) / BK + 1 - kt0 + ns);
      if (window > 0 && mk.sinks == 0) na = max(0, max(0, w0 - window + 1) / BK - kt0);
    }
    auto acquire = [&](int n) {
      mbar_wait(full(n), (n / STAGES) & 1);
      fence_proxy_async();
    };
    auto release = [&](int n) {
      if (lane == 0) mbar_arrive(empty(n));
    };

    float dqacc[D / 128][64];
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) dqacc[h][i] = 0.f;

    Turns<WGS> turn(wgi, 2 * ntiles);
    mbar_wait(qbar, 0);
    for (int n = 0; n < na; ++n) {
      acquire(n);
      turn.skip();
      turn.skip();
      release(n);
    }
    for (int n = na; n < nb; ++n) {
      acquire(n);
      const int k0 = key0(n);
      float s[BK / 2], dp[BK / 2];
      turn.mine();
      wgmma_fence();
      qk<D, BK, C::ROWS>(s, wq, stage(n));             // S = Q K^T
      qk<D, BK, C::ROWS>(dp, wdo, stage(n) + C::kKV);  // dP = dO V^T
      wgmma_commit();
      turn.yours();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // masks only where the tile reaches past Sk, the diagonal or the
      // window's lower edge for some row of this warpgroup
      unsigned ds[BK / 4];
      const int* kvk = ROWS && mk.kvm ? mk.kvm + k0 + c2 : nullptr;
      const int* segk = ROWS && mk.seg ? mk.seg + k0 + c2 : nullptr;
      if (k0 + BK > sk || ROWS ||
          (causal && (k0 + BK - 1 > w0 || (window > 0 && w0 + 63 - k0 >= window))))
        grads<BK, true, ROWS>(s, dp, ds, l2, dl, sl2, scale, sk - k0 - c2, k0 + c2 - ra, causal,
                              window, mk.sinks - k0 - c2, kvk, segk, qid, dead);
      else
        grads<BK, false, ROWS>(s, dp, ds, l2, dl, sl2, scale, 0, 0, causal, window, 0, kvk,
                               segk, qid, dead);
      turn.mine();
      wgmma_fence();
      pv<D, BK>(dqacc, ds, stage(n));  // dQ += dS K
      wgmma_commit();
      turn.yours();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < D / 128; ++h) fence_regs(dqacc[h]);
      fence_regs(ds);
      release(n);
    }
    for (int n = max(na, nb); n < ntiles; ++n) {
      acquire(n);
      turn.skip();
      turn.skip();
      release(n);
    }

    // rows past sq are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row < sq) {
        bf16* out = dq + (static_cast<size_t>(bh) * sq + row) * D + c2;
#pragma unroll
        for (int h = 0; h < D / 128; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<unsigned*>(out + 128 * h + 8 * j) =
                pack_bf16(dqacc[h][4 * j + 2 * r], dqacc[h][4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D, int WGS, int BQ, int STAGES>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvm, const int* seg, void* dk, void* dv, int bh,
               int sq, int sk, float scale, int causal, int window, int sinks, int h,
               cudaStream_t st) {
  using C = DkvCfg<D, WGS, BQ, STAGES>;
  auto kernel = kvm || seg ? flash_bwd_dkv_wgmma_kernel<D, WGS, BQ, STAGES, true>
                           : flash_bwd_dkv_wgmma_kernel<D, WGS, BQ, STAGES, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sk + C::KEYS - 1) / C::KEYS);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kvm, seg, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, scale, causal, window, sinks, h);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int WGS, int BK, int STAGES>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* kvm, const int* seg, void* dq, int bh, int sq,
              int sk, float scale, int causal, int window, int sinks, int h, cudaStream_t st) {
  using C = DqCfg<D, WGS, BK, STAGES>;
  auto kernel = kvm || seg ? flash_bwd_dq_wgmma_kernel<D, WGS, BK, STAGES, true>
                           : flash_bwd_dq_wgmma_kernel<D, WGS, BK, STAGES, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + C::ROWS - 1) / C::ROWS);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kvm, seg, static_cast<bf16*>(dq), sq, sk,
      scale, causal, window, sinks, h);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of `wgs` consumer warpgroups (kernels/attention.py
// flash_bwd_plan): dK/dV of 128 keys (two warpgroups) or 64 (one) at head
// dim 128, 64 keys split by columns over two at 256, query tiles of 64 in a
// ring of three stages (two at 256); dQ of 128 query rows (two) or 64 (one)
// at head dim 128, 64 (one) at 256, key tiles of 64 in a ring of three
// (two at 256).
int dispatch_dkv(int d, int wgs, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const int* kvm, const int* seg, void* dk,
                 void* dv, int bh, int sq, int sk, float scale, int causal, int window,
                 int sinks, int h, cudaStream_t st) {
  if (d == 128 && wgs == 2)
    return launch_dkv<128, 2, 64, 3>(q, k, v, dout, lse, delta, kvm, seg, dk, dv, bh, sq, sk,
                                     scale, causal, window, sinks, h, st);
  if (d == 128 && wgs == 1)
    return launch_dkv<128, 1, 64, 3>(q, k, v, dout, lse, delta, kvm, seg, dk, dv, bh, sq, sk,
                                     scale, causal, window, sinks, h, st);
  if (d == 256 && wgs == 2)
    return launch_dkv<256, 2, 64, 2>(q, k, v, dout, lse, delta, kvm, seg, dk, dv, bh, sq, sk,
                                     scale, causal, window, sinks, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_dq(int d, int wgs, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* kvm, const int* seg, void* dq,
                int bh, int sq, int sk, float scale, int causal, int window, int sinks, int h,
                cudaStream_t st) {
  if (d == 128 && wgs == 2)
    return launch_dq<128, 2, 64, 3>(q, k, v, dout, lse, delta, kvm, seg, dq, bh, sq, sk, scale,
                                    causal, window, sinks, h, st);
  if (d == 128 && wgs == 1)
    return launch_dq<128, 1, 64, 3>(q, k, v, dout, lse, delta, kvm, seg, dq, bh, sq, sk, scale,
                                    causal, window, sinks, h, st);
  if (d == 256 && wgs == 1)
    return launch_dq<256, 1, 64, 2>(q, k, v, dout, lse, delta, kvm, seg, dq, bh, sq, sk, scale,
                                    causal, window, sinks, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wg

}  // namespace

// q and dout (bh, sq, d), k and v (bh, sk, d), lse and delta (bh, sq) f32;
// dk, dv like k; d 128 or 256; all contiguous and 16-byte aligned.  window
// <= 0 means no sliding window; sinks: the first keys every row keeps under
// a window.  kvm (b, sk) and seg (b, sq) int32 with b = bh / h, or null:
// the key-padding rows and the segment ids (sq == sk) of flash_mask.cuh.
// wgs: the consumer warpgroups of the bf16 kernel's CTA
// (kernels/attention.py flash_bwd_plan; f32 ignores it).  dtype: 0 =
// float32, 1 = bfloat16.  Built with -DFLASH_BWD_WMMA_BF16, bf16 runs the
// f32 kernel's WMMA tile (chip_smoke.py's A/B of the two).  Returns
// cudaGetLastError().
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* kvm, const void* seg,
                             void* dk, void* dv, int bh, int sq, int sk, int d, float scale,
                             int causal, int window, int sinks, int h, int wgs, int dtype,
                             void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kvm);
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 1) {
#ifdef FLASH_BWD_WMMA_BF16
    return dispatch<__nv_bfloat16>(d, q, k, v, dout, l, dl, km, sg, nullptr, dk, dv, bh,
                                   sq, sk, scale, causal, window, sinks, h, true, stream);
#else
    return wg::dispatch_dkv(d, wgs, q, k, v, dout, l, dl, km, sg, dk, dv, bh, sq, sk, scale,
                            causal, window, sinks, h, static_cast<cudaStream_t>(stream));
#endif
  }
  return dispatch<float>(d, q, k, v, dout, l, dl, km, sg, nullptr, dk, dv, bh, sq, sk,
                         scale, causal, window, sinks, h, true, stream);
}

// dq like q; the other operands as for flash_bwd_dkv.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kvm, const void* seg, void* dq,
                            int bh, int sq, int sk, int d, float scale, int causal,
                            int window, int sinks, int h, int wgs, int dtype, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* km = static_cast<const int*>(kvm);
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 1) {
#ifdef FLASH_BWD_WMMA_BF16
    return dispatch<__nv_bfloat16>(d, q, k, v, dout, l, dl, km, sg, dq, nullptr, nullptr,
                                   bh, sq, sk, scale, causal, window, sinks, h, false, stream);
#else
    return wg::dispatch_dq(d, wgs, q, k, v, dout, l, dl, km, sg, dq, bh, sq, sk, scale, causal,
                           window, sinks, h, static_cast<cudaStream_t>(stream));
#endif
  }
  return dispatch<float>(d, q, k, v, dout, l, dl, km, sg, dq, nullptr, nullptr, bh, sq,
                         sk, scale, causal, window, sinks, h, false, stream);
}
