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
// Bound on the H100: at the train step's shapes (S 1024, D 128 or 256) the
// operations, 4 Sq Sk D per head halved by causality, are ~250 flop per
// byte of q, k, v and o, near the ~295 flop/byte ridge: a perfect kernel is
// bound by the tensor cores there, and by the bytes at the serving
// prefill's short rows.
//
// bf16 (namespace wg) runs on wgmma.  A CTA is one or two consumer
// warpgroups of 64 query rows (kernels/attention.py flash_plan decides, from
// shapes, before launch; two only at head dim 128) and one producer
// warpgroup:
//   - copies: the producer streams K and V tiles (128 keys at head dim 128
//     with 128 query rows, else 64) through a ring of shared-memory stages
//     (three at 128 x 128, else two) with cp.async, which zero-fills rows
//     past Sk and writes the 128-byte swizzle itself; mbarriers say a stage
//     landed (cp.async.mbarrier.arrive) and that every consumer warp is
//     done with it, so the two consumers drift apart and one's softmax runs
//     beside the other's MMAs.  TMA would need a tensor map from libcuda's
//     cuTensorMapEncodeTiled, which the plain-C build does not bind;
//     setmaxnreg moves the producer's registers to the consumers (40 /
//     232);
//   - S = Q K^T: wgmma with Q and K from shared memory, both K-major; S
//     stays in registers;
//   - softmax in registers: each thread holds two rows' values, reduced over
//     a quad of lanes; scores in base 2 (scale log2 e folded), lse returned
//     in natural log; the masks only on tiles that reach past Sk, the
//     diagonal or a window's lower edge;
//   - O += P V: P, rounded to bf16 against the running max, is the A operand
//     from registers in the accumulator's own layout; V is an MN-major B
//     (transposed descriptor); O (64 x D f32) stays in registers until the
//     epilogue; shared memory carries no S, P or O tile;
//   - S of tile n and PV of tile n - 1 are issued together, and two
//     consumers take turns at issuing (named barriers), one turn per key
//     tile of the CTA whether or not it is live for the warpgroup's rows,
//     so that one's softmax runs beside the other's MMAs; at head dim 256
//     (one consumer) tile n's softmax also overlaps that PV (at 128 ptxas
//     would serialise every MMA of the kernel for it);
//   - the last query tiles (the longest causal rows) are scheduled first.
// f32 keeps the CUDA-core tile below (TF32 would break the f32 contract).
// Built with -DFLASH_WMMA_BF16, bf16 runs that tile's WMMA form instead
// (chip_smoke.py's A/B of the two).
//
// The masks beyond causal and the window (flash_mask.cuh), as the TPU
// kernel takes them: attention sinks, a key-padding row and segment ids.
// Tiles below a CTA's band that hold sink columns are streamed first, and
// under sinks a warpgroup computes every tile from 0 (one it needs not is
// wholly masked and leaves its rows as they were); a key row or ids mask
// every tile and skip none.  A row with no visible key keeps m = -1e30,
// averages v over the keys of its tiles and returns lse -1e30, as the TPU
// kernel does.  The wgmma kernel is instantiated for each set of masks a
// call can take (MASKS), so that a call pays for none it does not use.
//
// The CUDA-core / WMMA tile: one CTA of 4 warps per (batch*head, 64-query
// tile); K/V tiles of BK rows stream through shared memory; each warp owns
// 16 query rows end to end (QK^T, online softmax, PV), so the only block
// barriers are around the tile loads.  bf16 uses WMMA 16x16x16 with f32
// accumulation; f32 keeps full f32 on the CUDA cores.  The running max and
// sum live in shared memory beside the f32 O tile that the WMMA
// accumulator is reloaded from.  BK is 64 at D 128 and 32 at D 256, where
// the f32 Q, K, V and O tiles of 64-row K/V tiles would need 281 KB of the
// 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "wgmma.cuh"

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

[[maybe_unused]] __device__ __forceinline__ void store_o(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_o(float* dst, float v) { *dst = v; }

template <typename T, int D, int BK, bool ROWS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kvm,
                 const int* __restrict__ seg, int sq, int sk, float scale,
                 int causal, int window, int sinks, int h) {
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
  const FlashMask mk(causal, window, sinks, kvm, seg, bh, h, sq, sk);
  const int gid = mk.id(grow, sq);

  const int n_kt = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!mk.tile_live(q0, BQ, kt * BK, BK)) continue;
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
      s = col < sk && mk.keep<ROWS>(grow, col, gid) ? s : kNegInf;
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
           const int* kvm, const int* seg, int bh, int sq, int sk, float scale,
           int causal, int window, int sinks, int h, void* stream) {
  constexpr size_t bytes = Tiles<T, D, BK>::smem_bytes();
  auto kernel = kvm || seg ? flash_fwd_kernel<T, D, BK, true> : flash_fwd_kernel<T, D, BK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kvm, seg, sq, sk, scale,
      causal, window, sinks, h);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for head dim d: 64-row key tiles at 128, 32 at 256.
template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, const int* kvm, const int* seg, int bh, int sq, int sk,
             float scale, int causal, int window, int sinks, int h, void* stream) {
  if (d == 128)
    return launch<T, 128, 64>(q, k, v, o, lse, kvm, seg, bh, sq, sk, scale, causal, window,
                              sinks, h, stream);
  if (d == 256)
    return launch<T, 256, 32>(q, k, v, o, lse, kvm, seg, bh, sq, sk, scale, causal, window,
                              sinks, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// bf16 on wgmma
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using sm90::load_tile;  // not the WMMA tile's above
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One instantiation: head dim D, WGS consumer warpgroups of 64 query rows
// each, key tiles of BK rows in a ring of STAGES.  The CTA is the consumer
// warpgroups and one producer warpgroup.  Shared memory (after up to 1 KB
// that aligns it): the Q tile, the ring of (K tile, V tile), then the
// mbarriers; each tile D / 64 swizzle atoms of its rows x 128 bytes
// (wgmma.cuh).
template <int D, int WGS, int BK, int STAGES>
struct Cfg {
  static constexpr int BQ = 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kQ = BQ * D * 2;
  static constexpr int kKV = BK * D * 2;       // K or V of one stage
  static constexpr int kBars = kQ + STAGES * 2 * kKV;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * STAGES);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// The masks an instantiation of the wgmma kernel takes (MASKS): 0 causal
// and the window, as the kernel was before sinks; 1 with sinks; 2 with a
// key row or ids (and sinks).  A call takes the least that serves it, so
// that what it does not use costs it nothing.
//
// A masked tile's rules for this thread's scores (rows ra + Elem::row,
// columns c0 + Elem::col): columns < cmax are in bounds; col - row = dbase +
// Elem::col - Elem::row; columns < smax are sinks (MASKS >= 1); and with
// MASKS 2 the key row and ids from column c0 on (kvm, seg, or null) against
// the ids id0, id8 of the thread's two rows.  All by value: a struct taken
// by reference here went to the stack.
template <int BK, bool MASK, int MASKS, int I = 0>
__device__ __forceinline__ void scale_mask(float (&s)[BK / 2], float (&mx)[2][2], float sl2,
                                           int cmax, int dbase, int causal, int window,
                                           int smax, const int* kvm, const int* seg, int id0,
                                           int id8) {
  if constexpr (I < BK / 2) {
    float x = s[I] * sl2;
    if constexpr (MASK) {
      constexpr int c = Elem<I>::col;
      const int d = dbase + (c - Elem<I>::row);
      bool keep;
      if constexpr (MASKS >= 1)
        keep = c < cmax && (!causal || (d <= 0 && (window <= 0 || d > -window || c < smax)));
      else
        keep = c < cmax && (!causal || (d <= 0 && (window <= 0 || d > -window)));
      if constexpr (MASKS == 2)
        keep = keep && (kvm == nullptr || kvm[c] != 0) &&
               (seg == nullptr || seg[c] == (Elem<I>::row ? id8 : id0));
      x = keep ? x : kNegInf;
    }
    s[I] = x;
    mx[(I / 2) % 2][I % 2] = fmaxf(mx[(I / 2) % 2][I % 2], x);
    scale_mask<BK, MASK, MASKS, I + 1>(s, mx, sl2, cmax, dbase, causal, window, smax, kvm, seg,
                                      id0, id8);
  }
}

// The online softmax of one S tile in registers: scores in base 2 (times
// sl2 = scale log2 e), masked to -1e30 where MASK, the running max m and
// this thread's share of the running sum l updated, alpha the factor the
// output rescales by, and P rounded to bf16 against the new max, in the
// accumulator's own layout (registers 4kk.. hold keys 16kk..): PV's A
// operand.  A row's BK / 4 values lie on a quad of lanes.
template <int BK, bool MASK, int MASKS>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], unsigned (&p)[BK / 4], float sl2,
                                        int cmax, int dbase, int causal, int window, int smax,
                                        const int* kvm, const int* seg, int id0, int id8) {
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
  scale_mask<BK, MASK, MASKS>(s, mx, sl2, cmax, dbase, causal, window, smax, kvm, seg, id0, id8);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2][2] = {};
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const int r = i % 2;
    const float p0 = exp2_approx(s[2 * i] - m[r]), p1 = exp2_approx(s[2 * i + 1] - m[r]);
    sum[r][(i / 2) % 2] += p0 + p1;
    p[i] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
}

template <int D, int WGS, int BK, int STAGES, int MASKS>
__global__ void __launch_bounds__(128 * WGS + 128, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, const int* __restrict__ kvm,
                       const int* __restrict__ seg, int sq, int sk, float scale, int causal,
                       int window, int sinks, int h) {
  using C = Cfg<D, WGS, BK, STAGES>;
  constexpr bool ROWS = MASKS == 2;
  // Whether a tile's softmax overlaps the PV product of the tile before:
  // at head dim 128 ptxas serialises every MMA of the kernel when
  // registers are defined while a group is partly retired (C7513), so
  // there S(n) and PV(n - 1) are only issued together; under a key row or
  // ids the overlap's registers would spill at head dim 256
  constexpr bool kOverlap = D == 256 && !ROWS;
  extern __shared__ unsigned char smem[];
  const unsigned sQ = (smem_addr(smem) + 1023) & ~1023u, sKV = sQ + C::kQ;
  const unsigned qbar = sQ + C::kBars;  // then full[STAGES], empty[STAGES]
  auto full = [&](int n) { return qbar + 8 + 8 * (n % STAGES); };
  auto empty = [&](int n) { return qbar + 8 + 8 * STAGES + 8 * (n % STAGES); };
  auto stage = [&](int n) { return sKV + (n % STAGES) * 2 * C::kKV; };
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // the last query tiles (the longest causal rows) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;

  // the live key tiles: causal tiles wholly above the diagonal of the
  // CTA's last row, and with a window those wholly below the band of its
  // first, are skipped, except the ns tiles that hold sink columns below
  // the band.  Tile n of the CTA is key tile n (n < ns), then kt0 + n - ns
  const FlashMask mk(causal, window, sinks, kvm, seg, bh, h, sq, sk);
  const int last = min(q0 + C::BQ, sq) - 1;
  int kt0 = 0, kt1 = (sk + BK - 1) / BK, ns = 0;
  if (causal) {
    kt1 = min(kt1, last / BK + 1);
    if (window > 0) {
      kt0 = max(0, q0 - window + 1) / BK;
      if constexpr (MASKS >= 1) ns = min(kt0, (mk.sinks + BK - 1) / BK);
    }
  }
  const int ntiles = ns + kt1 - kt0;
  auto key0 = [&](int n) { return (n < ns ? n : kt0 + n - ns) * BK; };

  if (tid == 0) {
    mbar_init(qbar, 128);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);        // the producer warpgroup's copies landed
      mbar_init(empty(st), 4 * WGS);   // every consumer warp done with the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {
    // the producer warpgroup: Q, then each live K/V tile into the ring, a
    // stage refilled once every consumer warp is done with it.  Two
    // consumers take the registers it gives up (168 each at entry: 40 here,
    // 232 there)
    if constexpr (WGS == 2) setmaxnreg_dec<40>();
    const int t = tid - C::kConsumers;
    load_tile<D, C::BQ, 128>(sQ, q + static_cast<size_t>(bh) * sq * D, q0, sq, t);
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
    const unsigned wq = sQ + wgi * 64 * 128;  // its rows in each Q atom
    const float sl2 = scale * kLog2e;  // base 2: exp2(s sl2) = exp(s scale)
    const int id0 = ROWS ? mk.id(ra, sq) : 0, id8 = ROWS ? mk.id(ra + 8, sq) : 0;

    // the tiles [na, nb) with a visible pair for this warpgroup's rows.
    // With sinks every tile from 0 on: a tile the CTA takes for the other
    // warpgroup's band is then wholly masked here, which leaves m, l and
    // the output as they were
    int na = 0, nb = w0 < sq ? ntiles : 0;
    if (w0 < sq && causal) {
      nb = min(ntiles, min(w0 + 63, sq - 1) / BK + 1 - kt0 + ns);
      if (window > 0 && (MASKS == 0 || mk.sinks == 0))
        na = max(0, max(0, w0 - window + 1) / BK - kt0);
    }
    auto acquire = [&](int n) {
      mbar_wait(full(n), (n / STAGES) & 1);
      fence_proxy_async();
    };
    auto release = [&](int n) {
      if (lane == 0) mbar_arrive(empty(n));
    };
    // masks only where a tile reaches past Sk, the diagonal or the
    // window's lower edge for some row of this warpgroup, and on every tile
    // under a key row or ids
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    auto scores = [&](float (&s)[BK / 2], unsigned (&p)[BK / 4], int n) {
      const int k0 = key0(n);
      const int* kvc = ROWS && mk.kvm ? mk.kvm + k0 + c2 : nullptr;
      const int* segc = ROWS && mk.seg ? mk.seg + k0 + c2 : nullptr;
      if (k0 + BK > sk || ROWS ||
          (causal && (k0 + BK - 1 > w0 || (window > 0 && w0 + 63 - k0 >= window))))
        softmax<BK, true, MASKS>(s, m, l, alpha, p, sl2, sk - k0 - c2, k0 + c2 - ra, causal,
                                window, mk.sinks - k0 - c2, kvc, segc, id0, id8);
      else
        softmax<BK, false, MASKS>(s, m, l, alpha, p, sl2, 0, 0, causal, window, 0, kvc, segc,
                                 id0, id8);
    };

    float oacc[D / 128][64];
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) oacc[h][i] = 0.f;

    // With two consumers, their MMA bursts take turns (named barriers 1 and
    // 2), so that one's softmax runs beside the other's MMAs, warpgroup 0
    // first.  Each takes turn n (1 <= n < ntiles) for key tile n of the CTA,
    // live for its rows or not, holding no tile past n and having released
    // every tile before n - 1: the turn one waits for then never needs a
    // stage the waiter holds, so neither can stall the ring.  Warpgroup 1's
    // last turn hands over nothing, so that every arrive is awaited
    const int turns = ntiles - 1;
    int taken = 0;
    auto my_turn = [&] {
      if constexpr (WGS == 2) named_sync(1 + wgi, 256);
    };
    auto your_turn = [&] {
      ++taken;
      if constexpr (WGS == 2)
        if (wgi == 0 || taken < turns) named_arrive(2 - wgi, 256);
    };
    auto turns_to = [&](int n) {  // the turns up to n, empty
      while (taken < n) {
        my_turn();
        your_turn();
      }
    };
    if (WGS == 2 && wgi == 1 && turns > 0) named_arrive(1, 256);
    mbar_wait(qbar, 0);
    for (int n = 0; n < na; ++n) {
      acquire(n);
      turns_to(n);
      release(n);
    }
    if (na < nb) {
      // S of tile n and PV of tile n - 1 issued together, one run of the
      // tensor cores
      float s[BK / 2];
      unsigned p[BK / 4];
      acquire(na);
      turns_to(na);
      wgmma_fence();
      qk<D, BK, C::BQ>(s, wq, stage(na));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      scores(s, p, na);
      for (int n = na + 1; n < nb; ++n) {
        acquire(n);
        float s2[BK / 2];
        unsigned p2[BK / 4];
        my_turn();
        wgmma_fence();
        qk<D, BK, C::BQ>(s2, wq, stage(n));
        wgmma_commit();
        pv<D, BK>(oacc, p, stage(n - 1) + C::kKV);
        wgmma_commit();
        your_turn();
        // with kOverlap, tile n's softmax runs while PV(n - 1) does
        wgmma_wait<kOverlap ? 1 : 0>();
        fence_regs(s2);
        scores(s2, p2, n);
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < D / 128; ++h) fence_regs(oacc[h]);
        fence_regs(p);
        release(n - 1);
#pragma unroll
        for (int h = 0; h < D / 128; ++h)
#pragma unroll
          for (int i = 0; i < 64; ++i) oacc[h][i] *= alpha[(i / 2) % 2];
#pragma unroll
        for (int i = 0; i < BK / 4; ++i) p[i] = p2[i];
      }
      wgmma_fence();
      pv<D, BK>(oacc, p, stage(nb - 1) + C::kKV);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < D / 128; ++h) fence_regs(oacc[h]);
      fence_regs(p);
      release(nb - 1);
    }
    for (int n = max(na, nb); n < ntiles; ++n) {
      acquire(n);
      turns_to(n);
      release(n);
    }
    turns_to(turns);

    // o = acc / l; lse = m + log(l) in natural log, -1e30 on a row with no
    // visible key (m still -1e30 there, as the JAX kernel's m + log(l)
    // rounds to); rows past sq not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = ra + 8 * r;
      const float inv = 1.f / l[r];
      if (row < sq) {
        bf16* orow = o + (static_cast<size_t>(bh) * sq + row) * D + c2;
#pragma unroll
        for (int h = 0; h < D / 128; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<unsigned*>(orow + 128 * h + 8 * j) =
                pack_bf16(oacc[h][4 * j + 2 * r] * inv, oacc[h][4 * j + 2 * r + 1] * inv);
        if (c2 == 0)
          lse[static_cast<size_t>(bh) * sq + row] =
              ROWS && m[r] == kNegInf ? kNegInf : m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

template <int D, int WGS, int BK, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const int* kvm,
           const int* seg, int bh, int sq, int sk, float scale, int causal, int window,
           int sinks, int h, cudaStream_t st) {
  using C = Cfg<D, WGS, BK, STAGES>;
  auto kernel = kvm || seg ? flash_fwd_wgmma_kernel<D, WGS, BK, STAGES, 2>
                : sinks > 0 && window > 0 ? flash_fwd_wgmma_kernel<D, WGS, BK, STAGES, 1>
                                          : flash_fwd_wgmma_kernel<D, WGS, BK, STAGES, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, kvm, seg, sq, sk, scale, causal, window, sinks, h);
  return static_cast<int>(cudaGetLastError());
}

// The tile of `rows` query rows per CTA (kernels/attention.py flash_plan):
// 128 (two consumer warpgroups, head dim 128 only) or 64 (one).  Key tiles
// of 128 rows at 128 query rows, in a ring of three stages; else 64 rows,
// two stages.
int dispatch(int d, int rows, const void* q, const void* k, const void* v, void* o,
             float* lse, const int* kvm, const int* seg, int bh, int sq, int sk, float scale,
             int causal, int window, int sinks, int h, cudaStream_t st) {
  if (d == 128 && rows == 128)
    return launch<128, 2, 128, 3>(q, k, v, o, lse, kvm, seg, bh, sq, sk, scale, causal, window,
                                  sinks, h, st);
  if (d == 128 && rows == 64)
    return launch<128, 1, 64, 2>(q, k, v, o, lse, kvm, seg, bh, sq, sk, scale, causal, window,
                                 sinks, h, st);
  if (d == 256 && rows == 64)
    return launch<256, 1, 64, 2>(q, k, v, o, lse, kvm, seg, bh, sq, sk, scale, causal, window,
                                 sinks, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wg

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o like q, lse (bh, sq) f32; d 128 or
// 256; all contiguous and 16-byte aligned.  window <= 0 means no sliding
// window; sinks: the first keys every row keeps under a window.  kvm (b,
// sk) and seg (b, sq) int32 with b = bh / h, or null: the key-padding rows
// and the segment ids (sq == sk) of flash_mask.cuh.  rows: the query rows per CTA of the bf16 kernel (64, or 128 at
// head dim 128; kernels/attention.py flash_plan; f32 ignores it).  dtype:
// 0 = float32, 1 = bfloat16.  Built with -DFLASH_WMMA_BF16, bf16 runs the
// f32 kernel's WMMA tile (chip_smoke.py's A/B of the two).  Returns
// cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kvm,
                         const void* seg, void* o, void* lse, int bh, int sq, int sk, int d,
                         float scale, int causal, int window, int sinks, int h, int rows,
                         int dtype, void* stream) {
  float* l = static_cast<float*>(lse);
  const int* km = static_cast<const int*>(kvm);
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 1) {
#ifdef FLASH_WMMA_BF16
    return dispatch<__nv_bfloat16>(d, q, k, v, o, l, km, sg, bh, sq, sk, scale, causal, window,
                                   sinks, h, stream);
#else
    return wg::dispatch(d, rows, q, k, v, o, l, km, sg, bh, sq, sk, scale, causal, window,
                        sinks, h, static_cast<cudaStream_t>(stream));
#endif
  }
  return dispatch<float>(d, q, k, v, o, l, km, sg, bh, sq, sk, scale, causal, window, sinks,
                         h, stream);
}
