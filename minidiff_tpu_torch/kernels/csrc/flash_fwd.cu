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
// K/V tiles of BK rows stream through shared memory; each warp owns 16 query
// rows end to end (QK^T, online softmax, PV), so the only block barriers are
// around the tile loads.  bf16 uses WMMA 16x16x16 with f32 accumulation;
// f32 keeps full f32 on the CUDA cores (TF32 would break the f32 contract).
// The running max and sum live in shared memory beside the f32 O tile that
// the WMMA accumulator is reloaded from, because WMMA fragments do not expose
// which row an element belongs to.  Head dims 128 and 256 are the two
// instantiations, as _flash_eligible takes them: BK is 64 at D 128 and 32 at
// D 256, where the f32 Q, K, V and O tiles of 64-row K/V tiles would need
// 281 KB of the 227 KB a block may use.  wgmma, TMA and register-resident P
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kNegInf = -1e30f;

// Shared-memory row strides (elements) of one instantiation, head dim D and
// key tiles of BK rows.  bf16: multiples of 8 as WMMA asks, with 8 bf16 of
// padding; f32 operand tiles: D + 1 so the scalar QK^T loop's lanes (one
// key row each) fall on distinct banks.
template <typename T, int D, int BK>
struct Tiles {
  static constexpr int LD = sizeof(T) == 2 ? D + 8 : D + 1;  // Q, K, V
  static constexpr int LDS = BK + 4;  // f32 scores / probabilities
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 output accumulator

  static constexpr size_t smem_bytes() {
    return static_cast<size_t>(BQ + 2 * BK) * LD * sizeof(T)   // Q, K, V
           + static_cast<size_t>(BQ) * LDS * sizeof(float)     // scores
           + (sizeof(T) == 2 ? static_cast<size_t>(BQ) * LDP * 2 : 0)
           + static_cast<size_t>(BQ) * LDO * sizeof(float)     // O
           + 2ull * BQ * sizeof(float);                        // m, l
  }
};

// Copy rows [r0, r0 + ROWS) of a (S, D) matrix into a shared tile of stride
// LD, zeros past S.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int s) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < s) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int s) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = (r0 + r < s) ? src[static_cast<size_t>(r0 + r) * D + c] : 0.f;
  }
}

// S[16 rows of this warp][BK] = Q K^T (unscaled, f32) into sS.
template <int D, int BK>
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* sQ,
                                        const __nv_bfloat16* sK, float* sS,
                                        int warp, int lane) {
  using L = Tiles<__nv_bfloat16, D, BK>;
  for (int nt = 0; nt < BK / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + (16 * warp) * L::LD + 16 * kk, L::LD);
      // K stored (key, d) row-major is K^T in column-major
      wmma::load_matrix_sync(b, sK + (16 * nt) * L::LD + 16 * kk, L::LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sS + (16 * warp) * L::LDS + 16 * nt, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

template <int D, int BK>
__device__ __forceinline__ void qk_tile(const float* sQ, const float* sK,
                                        float* sS, int warp, int lane) {
  using L = Tiles<float, D, BK>;
  constexpr int KPL = BK / 32;  // keys per lane
  float acc[16][KPL];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc[r][j] = 0.f;
  const float* q = sQ + (16 * warp) * L::LD;
  for (int d = 0; d < D; ++d) {
    float kv[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) kv[j] = sK[(lane + 32 * j) * L::LD + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = q[r * L::LD + d];
#pragma unroll
      for (int j = 0; j < KPL; ++j) acc[r][j] = fmaf(qv, kv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      sS[(16 * warp + r) * L::LDS + lane + 32 * j] = acc[r][j];
}

// sO[16 rows of this warp] += P V, P from sP (bf16) or sS (f32).
template <int D, int BK>
__device__ __forceinline__ void pv_tile(const __nv_bfloat16* sP,
                                        const float* /*sS*/,
                                        const __nv_bfloat16* sV, float* sO,
                                        int warp, int lane) {
  using L = Tiles<__nv_bfloat16, D, BK>;
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* o = sO + (16 * warp) * L::LDO + 16 * nt;
    wmma::load_matrix_sync(acc, o, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + (16 * warp) * L::LDP + 16 * kk, L::LDP);
      wmma::load_matrix_sync(b, sV + (16 * kk) * L::LD + 16 * nt, L::LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, L::LDO, wmma::mem_row_major);
  }
}

template <int D, int BK>
__device__ __forceinline__ void pv_tile(const float* /*sP*/, const float* sS,
                                        const float* sV, float* sO, int warp,
                                        int lane) {
  using L = Tiles<float, D, BK>;
  for (int r = 0; r < 16; ++r) {
    const float* p = sS + (16 * warp + r) * L::LDS;
    float acc[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc[j] = 0.f;
    for (int k = 0; k < BK; ++k) {
      const float pk = p[k];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[j] = fmaf(pk, sV[k * L::LD + lane + 32 * j], acc[j]);
    }
    float* o = sO + (16 * warp + r) * L::LDO;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[lane + 32 * j] += acc[j];
  }
}

template <int LDS, int LDP>
__device__ __forceinline__ void store_p(__nv_bfloat16* sP, float* /*sS*/, int row,
                                        int col, float p) {
  sP[row * LDP + col] = __float2bfloat16_rn(p);
}
template <int LDS, int LDP>
__device__ __forceinline__ void store_p(float* /*sP*/, float* sS, int row,
                                        int col, float p) {
  sS[row * LDS + col] = p;
}

__device__ __forceinline__ void store_o(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_o(float* dst, float v) { *dst = v; }

// Whether key tile kt (of BK rows) holds any (row, col) pair visible to
// query tile qt.
template <int BK>
__device__ __forceinline__ bool tile_live(int qt, int kt, int causal,
                                          int window) {
  if (!causal) return true;
  const bool causal_live = kt * BK <= qt * BQ + BQ - 1;
  if (window <= 0) return causal_live;
  return causal_live && (kt * BK + BK - 1 >= qt * BQ - (window - 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal, int window) {
  using L = Tiles<T, D, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * L::LD;
  T* sV = sK + BK * L::LD;
  float* sS = reinterpret_cast<float*>(sV + BK * L::LD);
  T* sP = reinterpret_cast<T*>(sS + BQ * L::LDS);
  float* sO = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sP) + (sizeof(T) == 2 ? BQ * L::LDP * 2 : 0));
  float* sM = sO + BQ * L::LDO;
  float* sL = sM + BQ;

  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  load_tile<D, BQ, L::LD>(sQ, qb, q0, sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = kNegInf;
    sL[threadIdx.x] = 0.f;
  }

  // softmax work split: two lanes per row, BK / 2 columns each
  constexpr int HALF = BK / 2;
  const int srow = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int grow = q0 + srow;

  const int n_kt = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live<BK>(qt, kt, causal, window)) continue;
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile<D, BK, L::LD>(sK, kb, k0, sk);
    load_tile<D, BK, L::LD>(sV, vb, k0, sk);
    __syncthreads();

    qk_tile<D, BK>(sQ, sK, sS, warp, lane);
    __syncwarp();

    // online softmax over this warp's rows
    float* srow_p = sS + srow * L::LDS + HALF * half;
    float mx = kNegInf;
    for (int j = 0; j < HALF; ++j) {
      const int col = k0 + HALF * half + j;
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
    for (int j = 0; j < HALF; ++j) {
      const float p = expf(srow_p[j] - m_new);
      sum += p;
      store_p<L::LDS, L::LDP>(sP, sS, srow, HALF * half + j, p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = sO + srow * L::LDO + (D / 2) * half;
    for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    __syncwarp();
    if (half == 0) {
      sL[srow] = alpha * sL[srow] + sum;
      sM[srow] = m_new;
    }

    pv_tile<D, BK>(sP, sS, sV, sO, warp, lane);
    __syncwarp();
  }
  __syncthreads();

  // flush: o = acc / l, lse = m + log(l); rows past sq are not stored
  if (grow < sq) {
    const float l = sL[srow];
    T* orow = o + (static_cast<size_t>(bh) * sq + grow) * D + (D / 2) * half;
    const float* acc = sO + srow * L::LDO + (D / 2) * half;
    for (int j = 0; j < D / 2; ++j) store_o(orow + j, acc[j] / l);
    if (half == 0) lse[static_cast<size_t>(bh) * sq + grow] = sM[srow] + logf(l);
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, float scale, int causal, int window,
           void* stream) {
  constexpr size_t bytes = Tiles<T, D, BK>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D, BK><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for head dim d: 64-row key tiles at 128, 32 at 256.
template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int sq, int sk, float scale, int causal,
             int window, void* stream) {
  if (d == 128)
    return launch<T, 128, 64>(q, k, v, o, lse, bh, sq, sk, scale, causal, window, stream);
  if (d == 256)
    return launch<T, 256, 32>(q, k, v, o, lse, bh, sq, sk, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o like q, lse (bh, sq) f32; d 128 or
// 256; all contiguous and 16-byte aligned.  dtype: 0 = float32, 1 =
// bfloat16.  window <= 0 means no sliding window.  Returns
// cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, int d, float scale,
                         int causal, int window, int dtype, void* stream) {
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, l, bh, sq, sk, scale, causal, window, stream);
  return dispatch<float>(d, q, k, v, o, l, bh, sq, sk, scale, causal, window, stream);
}
