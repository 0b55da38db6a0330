// Flash-attention forward for sm_90a: o = softmax(q k^T * scale) v and the
// per-row logsumexp, without the (S, S) score matrix ever reaching HBM.
//
// Replaces minidiff_tpu/kernels/attention.py _fwd_kernel (:171), reached
// through _flash_fwd (pallas_call at :274).  Same contract: scores in f32
// times `scale`; masked entries are -1e30 (not -inf), so a row whose first
// live tile is entirely masked is wiped by the next tile's zero alpha, as on
// the TPU; causal tiles wholly above the diagonal (and, with a sliding
// window, wholly below its band) are skipped, as _block_live does; o leaves
// in the input dtype and lse = m + log(l) in f32.  Ragged S is masked by
// bounds (keys >= Sk score -1e30, query rows >= Sq are not stored) instead
// of padding the operands to 128 as the TPU path does.
//
// Bound on the H100: at the serving path's shapes (D = 128, S <= 512) the
// bytes are q, k, v and o once each and the operations 4*S*Sk*D per head
// (halved by causality), about 32-128 flop/byte, under the ~295 flop/byte
// ridge: a perfect kernel is memory-bound, and this simple one is bound by
// its own shared-memory round trips and the tensor-core rate it reaches
// through WMMA.  Design: one CTA of 4 warps per (batch*head, 64-query tile);
// K/V tiles of 64 rows stream through shared memory; each warp owns 16 query
// rows end to end (QK^T, online softmax, PV), so the only block barriers are
// around the tile loads.  bf16 uses WMMA 16x16x16 with f32 accumulation;
// f32 keeps full f32 on the CUDA cores (TF32 would break the f32 contract).
// The running max and sum live in shared memory beside the f32 O tile that
// the WMMA accumulator is reloaded from, because WMMA fragments do not expose
// which row an element belongs to.  wgmma, TMA and register-resident P are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kNegInf = -1e30f;

// shared-memory row strides (elements).  bf16: multiples of 8 as WMMA asks,
// with 8 bf16 of padding; f32 operand tiles: D + 1 so the scalar QK^T loop's
// lanes (one key row each) fall on distinct banks.
template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> { static constexpr int LD = D + 8; };
template <> struct Layout<float> { static constexpr int LD = D + 1; };
constexpr int LDS = BK + 4;   // f32 scores / probabilities
constexpr int LDP = BK + 8;   // bf16 probabilities
constexpr int LDO = D + 4;    // f32 output accumulator

template <typename T>
constexpr size_t smem_bytes() {
  size_t ops = 3ull * BQ * Layout<T>::LD * sizeof(T);           // Q, K, V
  size_t s = static_cast<size_t>(BQ) * LDS * sizeof(float);     // scores
  size_t p = sizeof(T) == 2 ? static_cast<size_t>(BQ) * LDP * 2 : 0;
  size_t o = static_cast<size_t>(BQ) * LDO * sizeof(float);
  size_t stats = 2ull * BQ * sizeof(float);                      // m, l
  return ops + s + p + o + stats;
}

// Copy rows [r0, r0 + 64) of a (S, D) matrix into a shared tile, zeros past S.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int s) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BQ * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < s) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<__nv_bfloat16>::LD + c) = v;
  }
}

__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int s) {
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * Layout<float>::LD + c] =
        (r0 + r < s) ? src[static_cast<size_t>(r0 + r) * D + c] : 0.f;
  }
}

// S[16 rows of this warp][64] = Q K^T (unscaled, f32) into sS.
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* sQ,
                                        const __nv_bfloat16* sK, float* sS,
                                        int warp, int lane) {
  constexpr int LD = Layout<__nv_bfloat16>::LD;
  for (int nt = 0; nt < BK / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + (16 * warp) * LD + 16 * kk, LD);
      // K stored (key, d) row-major is K^T in column-major
      wmma::load_matrix_sync(b, sK + (16 * nt) * LD + 16 * kk, LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sS + (16 * warp) * LDS + 16 * nt, acc, LDS,
                            wmma::mem_row_major);
  }
}

__device__ __forceinline__ void qk_tile(const float* sQ, const float* sK,
                                        float* sS, int warp, int lane) {
  constexpr int LD = Layout<float>::LD;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  const float* q = sQ + (16 * warp) * LD;
  const float* k0 = sK + lane * LD;
  const float* k1 = sK + (lane + 32) * LD;
  for (int d = 0; d < D; ++d) {
    const float a0 = k0[d], a1 = k1[d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = q[r * LD + d];
      acc[r][0] = fmaf(qv, a0, acc[r][0]);
      acc[r][1] = fmaf(qv, a1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    sS[(16 * warp + r) * LDS + lane] = acc[r][0];
    sS[(16 * warp + r) * LDS + lane + 32] = acc[r][1];
  }
}

// sO[16 rows of this warp] += P V, P from sP (bf16) or sS (f32).
__device__ __forceinline__ void pv_tile(const __nv_bfloat16* sP,
                                        const float* /*sS*/,
                                        const __nv_bfloat16* sV, float* sO,
                                        int warp, int lane) {
  constexpr int LD = Layout<__nv_bfloat16>::LD;
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* o = sO + (16 * warp) * LDO + 16 * nt;
    wmma::load_matrix_sync(acc, o, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + (16 * warp) * LDP + 16 * kk, LDP);
      wmma::load_matrix_sync(b, sV + (16 * kk) * LD + 16 * nt, LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, LDO, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void pv_tile(const float* /*sP*/, const float* sS,
                                        const float* sV, float* sO, int warp,
                                        int lane) {
  constexpr int LD = Layout<float>::LD;
  for (int r = 0; r < 16; ++r) {
    const float* p = sS + (16 * warp + r) * LDS;
    float acc[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc[j] = 0.f;
    for (int k = 0; k < BK; ++k) {
      const float pk = p[k];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[j] = fmaf(pk, sV[k * LD + lane + 32 * j], acc[j]);
    }
    float* o = sO + (16 * warp + r) * LDO;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[lane + 32 * j] += acc[j];
  }
}

__device__ __forceinline__ void store_p(__nv_bfloat16* sP, float* /*sS*/, int row,
                                        int col, float p) {
  sP[row * LDP + col] = __float2bfloat16_rn(p);
}
__device__ __forceinline__ void store_p(float* /*sP*/, float* sS, int row,
                                        int col, float p) {
  sS[row * LDS + col] = p;
}

__device__ __forceinline__ void store_o(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_o(float* dst, float v) { *dst = v; }

// Whether key tile kt holds any (row, col) pair visible to query tile qt.
__device__ __forceinline__ bool tile_live(int qt, int kt, int causal,
                                          int window) {
  if (!causal) return true;
  const bool causal_live = kt * BK <= qt * BQ + BQ - 1;
  if (window <= 0) return causal_live;
  return causal_live && (kt * BK + BK - 1 >= qt * BQ - (window - 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal, int window) {
  constexpr int LD = Layout<T>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BK * LD;
  float* sS = reinterpret_cast<float*>(sV + BK * LD);
  T* sP = reinterpret_cast<T*>(sS + BQ * LDS);
  float* sO = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sP) + (sizeof(T) == 2 ? BQ * LDP * 2 : 0));
  float* sM = sO + BQ * LDO;
  float* sL = sM + BQ;

  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  load_tile(sQ, qb, q0, sq);
  for (int i = threadIdx.x; i < BQ * LDO; i += kThreads) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = kNegInf;
    sL[threadIdx.x] = 0.f;
  }

  // softmax work split: two lanes per row, 32 columns each
  const int srow = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int grow = q0 + srow;

  const int n_kt = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(qt, kt, causal, window)) continue;
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile(sK, kb, k0, sk);
    load_tile(sV, vb, k0, sk);
    __syncthreads();

    qk_tile(sQ, sK, sS, warp, lane);
    __syncwarp();

    // online softmax over this warp's rows
    float* srow_p = sS + srow * LDS + 32 * half;
    float mx = kNegInf;
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + 32 * half + j;
      float s = srow_p[j] * scale;
      bool keep = col < sk;
      if (causal) {
        keep = keep && grow >= col;
        if (window > 0) keep = keep && (grow - col < window);
      }
      s = keep ? s : kNegInf;
      srow_p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = sM[srow];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
    for (int j = 0; j < 32; ++j) {
      const float p = expf(srow_p[j] - m_new);
      sum += p;
      store_p(sP, sS, srow, 32 * half + j, p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = sO + srow * LDO + 64 * half;
    for (int j = 0; j < 64; ++j) orow[j] *= alpha;
    __syncwarp();
    if (half == 0) {
      sL[srow] = alpha * sL[srow] + sum;
      sM[srow] = m_new;
    }

    pv_tile(sP, sS, sV, sO, warp, lane);
    __syncwarp();
  }
  __syncthreads();

  // flush: o = acc / l, lse = m + log(l); rows past sq are not stored
  if (grow < sq) {
    const float l = sL[srow];
    T* orow = o + (static_cast<size_t>(bh) * sq + grow) * D + 64 * half;
    const float* acc = sO + srow * LDO + 64 * half;
    for (int j = 0; j < 64; ++j) store_o(orow + j, acc[j] / l);
    if (half == 0) lse[static_cast<size_t>(bh) * sq + grow] = sM[srow] + logf(l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, float scale, int causal, int window,
           void* stream) {
  constexpr size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, sq, 128), k and v (bh, sk, 128), o like q, lse (bh, sq) f32; all
// contiguous and 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no sliding window.  Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, int d, float scale,
                         int causal, int window, int dtype, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, l, bh, sq, sk, scale, causal, window, stream);
  return launch<float>(q, k, v, o, l, bh, sq, sk, scale, causal, window, stream);
}
