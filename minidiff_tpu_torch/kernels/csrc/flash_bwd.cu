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
// Design.  dkv: one block per (batch*head, 64-key tile); it keeps its K and
// V tiles and f32 dK/dV accumulators in shared memory and walks the live
// 64-query tiles.  Each warp owns 16 KEY rows and computes the TRANSPOSED
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
// contract).  wgmma, TMA and register-resident accumulators are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int BT = 64;         // rows of every tile (BQ == BK)

// Shared-memory row strides (elements).  "C" tiles are the column operand
// of a score product (lanes walk their rows in the f32 loop, so f32 pads to
// D + 1 for distinct banks); "R" tiles are the row operand.  bf16 strides
// are multiples of 8 as WMMA asks.  In f32, P and dS overwrite the f32
// score buffers in place (LDP == LDS, no separate buffers).
template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> {
  static constexpr int LDC = D + 8, LDR = D + 8, LDS = BT + 4, LDP = BT + 8,
                       LDO = D + 4;
  static constexpr bool kSeparateP = true;
};
template <> struct Layout<float> {
  static constexpr int LDC = D + 1, LDR = D, LDS = BT + 1, LDP = BT + 1,
                       LDO = D;
  static constexpr bool kSeparateP = false;
};

// Shared-memory carve-up of one block: `acc` f32 accumulators (2 for dkv,
// 1 for dq), two f32 score buffers, two row-operand and two column-operand
// tiles, the P/dS buffers (bf16 only), then lse and delta.  Accumulators
// first keeps every WMMA pointer 32-byte aligned.
template <typename T>
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
    using L = Layout<T>;
    return static_cast<size_t>(n_acc) * BT * L::LDO * 4 + 2ull * BT * L::LDS * 4 +
           2ull * BT * L::LDR * sizeof(T) + 2ull * BT * L::LDC * sizeof(T) +
           (L::kSeparateP ? static_cast<size_t>(n_p) * BT * L::LDP * sizeof(T) : 0) +
           2ull * BT * 4;
  }

  __device__ Smem(unsigned char* base, int n_acc, int n_p) {
    using L = Layout<T>;
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

// Copy rows [r0, r0 + 64) of a (n, D) matrix into a tile of stride ld,
// zeros past n.
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

__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < n) ? src[static_cast<size_t>(r0 + r) * D + c] : 0.f;
  }
}

// 64 f32 values of a per-row vector (lse or delta), zeros past n.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n) {
  if (threadIdx.x < BT) dst[threadIdx.x] = (r0 + threadIdx.x < n) ? src[r0 + threadIdx.x] : 0.f;
}

// out[16 rows of this warp][64] = A[those rows] . B[64 rows]^T over D,
// unscaled f32.  A has stride lda, B stride ldb, out stride LDS.
__device__ __forceinline__ void rows_by_cols(const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B, int ldb,
                                             float* out, int warp, int lane) {
  constexpr int LDS = Layout<__nv_bfloat16>::LDS;
  for (int nt = 0; nt < BT / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + (16 * warp) * lda + 16 * kk, lda);
      // B stored (row, d) row-major is B^T in column-major
      wmma::load_matrix_sync(b, B + (16 * nt) * ldb + 16 * kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + (16 * warp) * LDS + 16 * nt, acc, LDS,
                            wmma::mem_row_major);
  }
}

__device__ __forceinline__ void rows_by_cols(const float* A, int lda,
                                             const float* B, int ldb,
                                             float* out, int warp, int lane) {
  constexpr int LDS = Layout<float>::LDS;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  const float* a = A + (16 * warp) * lda;
  const float* b0 = B + lane * ldb;
  const float* b1 = B + (lane + 32) * ldb;
  for (int d = 0; d < D; ++d) {
    const float v0 = b0[d], v1 = b1[d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float av = a[r * lda + d];
      acc[r][0] = fmaf(av, v0, acc[r][0]);
      acc[r][1] = fmaf(av, v1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    out[(16 * warp + r) * LDS + lane] = acc[r][0];
    out[(16 * warp + r) * LDS + lane + 32] = acc[r][1];
  }
}

// acc[16 rows of this warp][D] += P[those rows][64] . B[64][D].  P has
// stride LDP, B stride ldb, acc stride LDO.
__device__ __forceinline__ void acc_rows(const __nv_bfloat16* P,
                                         const __nv_bfloat16* B, int ldb,
                                         float* acc, int warp, int lane) {
  constexpr int LDP = Layout<__nv_bfloat16>::LDP;
  constexpr int LDO = Layout<__nv_bfloat16>::LDO;
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    float* o = acc + (16 * warp) * LDO + 16 * nt;
    wmma::load_matrix_sync(c, o, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, P + (16 * warp) * LDP + 16 * kk, LDP);
      wmma::load_matrix_sync(b, B + (16 * kk) * ldb + 16 * nt, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(o, c, LDO, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void acc_rows(const float* P, const float* B,
                                         int ldb, float* acc, int warp,
                                         int lane) {
  constexpr int LDP = Layout<float>::LDP;
  constexpr int LDO = Layout<float>::LDO;
  for (int r = 0; r < 16; ++r) {
    const float* p = P + (16 * warp + r) * LDP;
    float s[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) s[j] = 0.f;
    for (int k = 0; k < BT; ++k) {
      const float pk = p[k];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) s[j] = fmaf(pk, B[k * ldb + lane + 32 * j], s[j]);
    }
    float* o = acc + (16 * warp + r) * LDO;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[lane + 32 * j] += s[j];
  }
}

__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

// Whether key tile kt holds any (row, col) pair visible to query tile qt.
__device__ __forceinline__ bool tile_live(int qt, int kt, int causal,
                                          int window) {
  if (!causal) return true;
  const bool causal_live = kt * BK <= qt * BQ + BQ - 1;
  if (window <= 0) return causal_live;
  return causal_live && (kt * BK + BK - 1 >= qt * BQ - (window - 1));
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

// Write rows [r0, r0 + 64) of an f32 accumulator tile to a (n, D) output,
// rows past n dropped.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, int r0,
                                           int n) {
  constexpr int LDO = Layout<T>::LDO;
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (r0 + r < n) put(dst + static_cast<size_t>(r0 + r) * D + c, acc[r * LDO + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, float scale,
                     int causal, int window) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T> sm(smem, 2, 2);
  float* sdK = sm.acc;
  float* sdV = sm.acc + BT * L::LDO;
  T* sK = sm.r0;
  T* sV = sm.r1;
  T* sQ = sm.c0;
  T* sdO = sm.c1;

  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* dob = dout + static_cast<size_t>(bh) * sq * D;
  const float* lseb = lse + static_cast<size_t>(bh) * sq;
  const float* deltab = delta + static_cast<size_t>(bh) * sq;

  load_rows(sK, L::LDR, k + static_cast<size_t>(bh) * sk * D, k0, sk);
  load_rows(sV, L::LDR, v + static_cast<size_t>(bh) * sk * D, k0, sk);
  for (int i = threadIdx.x; i < 2 * BT * L::LDO; i += kThreads) sm.acc[i] = 0.f;

  // element work: two lanes per (key) row, 32 query columns each
  const int srow = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int kj = k0 + srow;

  const int n_qt = (sq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    if (!tile_live(qt, kt, causal, window)) continue;
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q, dO, lse and delta consumed
    load_rows(sQ, L::LDC, qb, q0, sq);
    load_rows(sdO, L::LDC, dob, q0, sq);
    load_vec(sm.lse, lseb, q0, sq);
    load_vec(sm.delta, deltab, q0, sq);
    __syncthreads();

    rows_by_cols(sK, L::LDR, sQ, L::LDC, sm.s, warp, lane);    // S^T
    rows_by_cols(sV, L::LDR, sdO, L::LDC, sm.dp, warp, lane);  // dP^T
    __syncwarp();
    for (int j = 0; j < 32; ++j) {
      const int col = 32 * half + j;
      const int e = srow * L::LDS + col;
      const float p = visible(q0 + col, kj, sq, sk, causal, window)
                          ? expf(sm.s[e] * scale - sm.lse[col]) : 0.f;
      const float ds = p * (sm.dp[e] - sm.delta[col]) * scale;
      put(sm.p + srow * L::LDP + col, p);
      put(sm.ds + srow * L::LDP + col, ds);
    }
    __syncwarp();
    acc_rows(sm.p, sdO, L::LDC, sdV, warp, lane);   // dV += P^T dO
    acc_rows(sm.ds, sQ, L::LDC, sdK, warp, lane);   // dK += dS^T Q
    __syncwarp();
  }
  __syncthreads();
  store_rows(dk + static_cast<size_t>(bh) * sk * D, sdK, k0, sk);
  store_rows(dv + static_cast<size_t>(bh) * sk * D, sdV, k0, sk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal, int window) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<T> sm(smem, 1, 1);
  float* sdQ = sm.acc;
  T* sQ = sm.r0;
  T* sdO = sm.r1;
  T* sK = sm.c0;
  T* sV = sm.c1;

  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  load_rows(sQ, L::LDR, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_rows(sdO, L::LDR, dout + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_vec(sm.lse, lse + static_cast<size_t>(bh) * sq, q0, sq);
  load_vec(sm.delta, delta + static_cast<size_t>(bh) * sq, q0, sq);
  for (int i = threadIdx.x; i < BT * L::LDO; i += kThreads) sdQ[i] = 0.f;

  // element work: two lanes per (query) row, 32 key columns each
  const int srow = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + srow;

  const int n_kt = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(qt, kt, causal, window)) continue;
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V consumed
    load_rows(sK, L::LDC, kb, k0, sk);
    load_rows(sV, L::LDC, vb, k0, sk);
    __syncthreads();

    rows_by_cols(sQ, L::LDR, sK, L::LDC, sm.s, warp, lane);    // S
    rows_by_cols(sdO, L::LDR, sV, L::LDC, sm.dp, warp, lane);  // dP
    __syncwarp();
    const float lse_r = sm.lse[srow], delta_r = sm.delta[srow];
    for (int j = 0; j < 32; ++j) {
      const int col = 32 * half + j;
      const int e = srow * L::LDS + col;
      const float p = visible(qi, k0 + col, sq, sk, causal, window)
                          ? expf(sm.s[e] * scale - lse_r) : 0.f;
      put(sm.ds + srow * L::LDP + col, p * (sm.dp[e] - delta_r) * scale);
    }
    __syncwarp();
    acc_rows(sm.ds, sK, L::LDC, sdQ, warp, lane);  // dQ += dS K
    __syncwarp();
  }
  __syncthreads();
  store_rows(dq + static_cast<size_t>(bh) * sq * D, sdQ, q0, sq);
}

template <typename T>
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
    constexpr size_t bytes = Smem<T>::bytes(2, 2);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sk + BK - 1) / BK, bh);
    flash_bwd_dkv_kernel<T><<<grid, kThreads, bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, sk, scale, causal, window);
  } else {
    constexpr size_t bytes = Smem<T>::bytes(1, 1);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_bwd_dq_kernel<T><<<grid, kThreads, bytes, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), sq, sk, scale,
        causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and dout (bh, sq, 128), k and v (bh, sk, 128), lse and delta (bh, sq)
// f32; dk, dv like k; all contiguous and 16-byte aligned.  dtype: 0 =
// float32, 1 = bfloat16.  window <= 0 means no sliding window.  Returns
// cudaGetLastError().
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, float scale, int causal,
                             int window, int dtype, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, l, dl, nullptr, dk, dv, bh, sq,
                                 sk, scale, causal, window, true, stream);
  return launch<float>(q, k, v, dout, l, dl, nullptr, dk, dv, bh, sq, sk, scale,
                       causal, window, true, stream);
}

// dq like q; the other operands as for flash_bwd_dkv.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, float scale, int causal, int window,
                            int dtype, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, nullptr, nullptr, bh,
                                 sq, sk, scale, causal, window, false, stream);
  return launch<float>(q, k, v, dout, l, dl, dq, nullptr, nullptr, bh, sq, sk,
                       scale, causal, window, false, stream);
}
