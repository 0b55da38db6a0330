// Matrix products for sm_90a: out = x @ y, x @ y^T and x^T @ y, with an f32
// accumulator and one cast to the operands' dtype at the end.
//
// Replaces minidiff_tpu/kernels/matmul.py:
//   matmul_nn <- _mm_kernel    (:106, pallas_call in _pallas_matmul_2d :128)
//   matmul_nt <- _mm_nt_kernel (:190, pallas_call in _pallas_matmul_nt_2d :231)
//   matmul_tn <- _mm_tn_kernel (:207, pallas_call in _pallas_matmul_tn_2d :261)
// The nt and tn forms read the "transposed" operand in its stored layout
// (y as (N, K), x as (K, M)): the tape's matmul VJPs never make a
// transposed copy.  Operands are row-major and contiguous; any M, N, K
// works (edge tiles are predicated and zero-filled).
//
// Bound on the H100: operations.  At the tape's shapes (M, N, K of 784 to
// 8192) a product does 2*M*N*K flops on (M*K + K*N + M*N) elements, several
// hundred flops per byte, above the ~295 flop/byte bf16 ridge.
//
// Three tiles; kernels/matmul.py mm_plan picks one from shapes and dtypes
// before launch and passes it here (`tile`):
//
// bf16 on wgmma (namespace wg; tile 128 or 256, the CTA's output columns),
// for rows that are whole 16-byte chunks (each operand's contiguous
// dimension a multiple of 8, as the TMA's row stride must be).  A CTA owns
// one 128 x tile output tile:
//   - a producer streams K-tiles of 64 of both operands into a ring of
//     shared-memory stages, each operand in its stored layout and in
//     128-byte swizzle atoms, zeros past M, N and K: one thread asks the
//     TMA for each stage's boxes (tensor maps encoded per launch by
//     libcuda's encoder, looked up through the CUDA runtime, so the
//     plain-C build links no libcuda).  Full mbarriers say a stage
//     landed, empty ones that each of the 8 consumer warps is done with it;
//   - two consumer warpgroups own 64 output rows each and run wgmma
//     m64 x tile x k16 with both operands from shared memory.  A tile
//     whose rows run along K (x in nn and nt, y in nt) is read K-major; one
//     whose rows run along M or N (x in tn, y in nn and tn) MN-major,
//     through the transpose immediates: the three layouts differ only
//     there and in the boxes.  One MMA group stays in flight
//     (wgmma.wait_group 1) before the stage it read is released; the first
//     MMA defines the accumulators, and nothing else touches them until the
//     last group has retired;
//   - 128 x 256: one CTA per SM, 4 stages, a producer warpgroup whose
//     registers go to the consumers (setmaxnreg 40 / 232).  128 x 128: two
//     CTAs per SM, 3 stages and a producer warp, so that one CTA's loads
//     and MMAs run beside the other's epilogue;
//   - the epilogue rounds the f32 accumulators to bf16 once, stages the
//     rows in the freed ring and stores them as 16-byte chunks of whole
//     rows, predicated at the M and N edges;
//   - CTAs walk `group` tile-rows column by column before moving on (a band
//     that shares its operand tiles in L2).  Each output tile has one owner:
//     no split-K, no atomics, the same bits on every run.
//
// bf16 on WMMA (tile 0): tensor cores through WMMA 16x16x16 (mma.sync
// underneath), for rows that are no whole number of 16-byte copies, and for
// every bf16 product of a build with -DMM_WMMA_BF16 (chip_smoke.py's A/B of
// the two).  One CTA of 8 warps per 128x128 output tile, each warp a 64x32
// sub-tile (4x2 fragments).  K advances in steps of 32 through a 3-stage
// ring of shared-memory tiles, so two tiles' loads are in flight while the
// third is multiplied.  A tile keeps its operand's global layout and WMMA
// reads it as row- or column-major.  Rows are padded by 8 bf16 so that the
// fragment loads hit distinct banks.  When a contiguous dimension is not a
// multiple of 8 the tiles are filled by plain predicated loads, else by
// 16-byte cp.async copies.  The epilogue stages each f32 fragment through
// shared memory (a WMMA fragment does not say which element it holds) and
// writes bf16 rows of 16 bytes.
//
// f32 (tile 0): FFMA on the CUDA cores with full f32 products (TF32 would
// break the f32 contract).  One CTA of 256 threads per 128x128 tile, each
// thread an 8x8 register tile (two 4-row by two 4-column blocks, so that
// the shared-memory reads are conflict-free float4s), K in steps of 8,
// double-buffered through shared memory by 4-byte cp.async copies: the
// next tile's copies are in flight while the current one is multiplied,
// and no register holds them.  Both operands sit in shared memory as [k][m]
// and [k][n]; a K-contiguous operand is transposed on its way in (rows
// padded by 4 floats, so the transposed stores hit distinct banks).
//
// Clusters with TMA multicast and a persistent tile schedule are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using namespace nvcuda;

constexpr int kNN = 0, kNT = 1, kTN = 2;

// ------------------------------------------------------------------------
// bf16: WMMA tensor cores (rows that are no whole number of 16-byte copies)
// ------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kStageLd = 20;   // f32 row stride of the epilogue's staging

// A shared tile of one operand: rows of K (kKRows) or rows of M / N.
template <bool kKRows, int MN>
struct Tile {
  static constexpr int ROWS = kKRows ? MN : BK;
  static constexpr int COLS = kKRows ? BK : MN;
  static constexpr int LD = COLS + kPad;
  static constexpr int ELEMS = ROWS * LD;
};

// The operand layouts of each variant: x is (M, K) in nn and nt, (K, M) in
// tn; y is (K, N) in nn and tn, (N, K) in nt.
template <int V>
struct Layout {
  static constexpr bool A_K = V != kTN;  // x's rows run along K
  static constexpr bool B_K = V == kNT;  // y's rows run along K
  using TA = Tile<A_K, BM>;
  using TB = Tile<B_K, BN>;
  static constexpr int STAGE = TA::ELEMS + TB::ELEMS;
  static constexpr size_t SMEM = static_cast<size_t>(kStages) * STAGE * 2;
};

// Fill a ROWS x COLS tile from the row-major global matrix `src` (row
// stride ld) at (r0, c0); elements at or past (rmax, cmax) read as zero.
// kVec: 16-byte cp.async copies, which needs cmax % 8 == 0 (a copy is then
// wholly in or wholly out) and ld % 8 == 0.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int r0, int c0, int rmax, int cmax) {
  if constexpr (kVec) {
    constexpr int CPR = T::COLS / 8;
    for (int i = threadIdx.x; i < T::ROWS * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < rmax && gc < cmax;
      const __nv_bfloat16* g = in ? src + static_cast<size_t>(gr) * ld + gc : src;
      sm90::cp_async16(sm90::smem_addr(dst + r * T::LD + c), g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < T::ROWS * T::COLS; i += kThreads) {
      const int r = i / T::COLS, c = i % T::COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * T::LD + c] = (gr < rmax && gc < cmax)
                               ? src[static_cast<size_t>(gr) * ld + gc]
                               : __float2bfloat16(0.f);
    }
  }
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ y,
               __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using L = Layout<V>;
  using TA = typename L::TA;
  using TB = typename L::TB;
  using ALayout = std::conditional_t<L::A_K, wmma::row_major, wmma::col_major>;
  using BLayout = std::conditional_t<L::B_K, wmma::col_major, wmma::row_major>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* sa = smem + stage * L::STAGE;
    __nv_bfloat16* sb = sa + TA::ELEMS;
    const int k0 = kt * BK;
    if constexpr (L::A_K)
      load_tile<TA, kVec>(sa, x, K, m0, k0, M, K);
    else
      load_tile<TA, kVec>(sa, x, M, k0, m0, K, M);
    if constexpr (L::B_K)
      load_tile<TB, kVec>(sb, y, K, n0, k0, N, K);
    else
      load_tile<TB, kVec>(sb, y, N, k0, n0, K, N);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    sm90::cp_async_commit();

    const __nv_bfloat16* sa = smem + (kt % kStages) * L::STAGE;
    const __nv_bfloat16* sb = sa + TA::ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        const int m = wm * WM + i * 16;
        wmma::load_matrix_sync(a[i], L::A_K ? sa + m * TA::LD + kk : sa + kk * TA::LD + m,
                               TA::LD);
      }
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        const int n = wn * WN + j * 16;
        wmma::load_matrix_sync(b[j], L::B_K ? sb + n * TB::LD + kk : sb + kk * TB::LD + n,
                               TB::LD);
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to stage the epilogue

  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 16 * kStageLd;
  const int r = lane >> 1, c = (lane & 1) * 8;
  const bool vec_out = (N % 8) == 0;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], kStageLd, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * WM + i * 16 + r;
      const int gc = n0 + wn * WN + j * 16 + c;
      const float* s = stage + r * kStageLd + c;
      if (gr < M) {
        __nv_bfloat16* o = out + static_cast<size_t>(gr) * N + gc;
        if (vec_out && gc + 8 <= N) {
          uint4 v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            __nv_bfloat162 p = __floats2bfloat162_rn(s[2 * e], s[2 * e + 1]);
            w[e] = *reinterpret_cast<uint32_t*>(&p);
          }
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          for (int e = 0; e < 8; ++e)
            if (gc + e < N) o[e] = __float2bfloat16(s[e]);
        }
      }
      __syncwarp();
    }
  }
}

template <int V, bool kVec>
cudaError_t launch_bf16(const void* x, const void* y, void* out, int m, int n,
                        int k, cudaStream_t st) {
  constexpr size_t bytes = Layout<V>::SMEM;
  // the opt-in to more than 48 KB of dynamic shared memory holds per
  // device, so it is set on every launch (it costs far less than the
  // launch) rather than once per process
  cudaError_t err = cudaFuncSetAttribute(
      mm_bf16_kernel<V, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_bf16_kernel<V, kVec><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(out), m, n, k);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch_bf16(const void* x, const void* y, void* out, int m,
                          int n, int k, cudaStream_t st) {
  // the contiguous dimension of each operand, which 16-byte copies split
  const int ax = V == kTN ? m : k;
  const int by = V == kNT ? k : n;
  if (ax % 8 == 0 && by % 8 == 0) return launch_bf16<V, true>(x, y, out, m, n, k, st);
  return launch_bf16<V, false>(x, y, out, m, n, k, st);
}

// ------------------------------------------------------------------------
// f32: CUDA-core FFMA
// ------------------------------------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 8;
constexpr int kFLd = FBM + 4;  // [k][m] and [k][n] rows, padded

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ out, int M, int N, int K) {
  constexpr bool A_K = V != kTN, B_K = V == kNT;
  __shared__ __align__(16) float As[2][FBK][kFLd];
  __shared__ __align__(16) float Bs[2][FBK][kFLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  constexpr int kPer = FBK * FBM / kThreads;  // elements each thread copies

  // this thread's kPer elements of x's tile lie at (k, m) = (ka + i dka,
  // ma + i dma): along K first for a K-contiguous operand, along M
  // otherwise, so that a warp reads neighbours; likewise y's (k, n)
  constexpr int dka = A_K ? 0 : kThreads / FBM, dma = A_K ? kThreads / FBK : 0;
  constexpr int dkb = B_K ? 0 : kThreads / FBN, dnb = B_K ? kThreads / FBK : 0;
  const int ka = A_K ? tid % FBK : tid / FBM, ma = A_K ? tid / FBK : tid % FBM;
  const int kb = B_K ? tid % FBK : tid / FBN, nb = B_K ? tid / FBK : tid % FBN;
  const float* xp = x + (A_K ? static_cast<size_t>(m0 + ma) * K + ka
                             : static_cast<size_t>(ka) * M + m0 + ma);
  const float* yp = y + (B_K ? static_cast<size_t>(n0 + nb) * K + kb
                             : static_cast<size_t>(kb) * N + n0 + nb);
  const size_t xs = A_K ? static_cast<size_t>(dma) * K : static_cast<size_t>(dka) * M;
  const size_t ys = B_K ? static_cast<size_t>(dnb) * K : static_cast<size_t>(dkb) * N;
  // the tile at k0 into buffer buf by 4-byte cp.async (zeros past the
  // edges), so that no register holds it while the other buffer is
  // multiplied
  auto load_tile = [&](int k0, int buf) {
    const size_t xk = A_K ? k0 : static_cast<size_t>(k0) * M;
    const size_t yk = B_K ? k0 : static_cast<size_t>(k0) * N;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool xin = k0 + ka + i * dka < K && m0 + ma + i * dma < M;
      const bool yin = k0 + kb + i * dkb < K && n0 + nb + i * dnb < N;
      sm90::cp_async4(sm90::smem_addr(&As[buf][ka + i * dka][ma + i * dma]),
                      xin ? xp + xk + i * xs : x, xin ? 4 : 0);
      sm90::cp_async4(sm90::smem_addr(&Bs[buf][kb + i * dkb][nb + i * dnb]),
                      yin ? yp + yk + i * ys : y, yin ? 4 : 0);
    }
    sm90::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (K + FBK - 1) / FBK;
  load_tile(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every thread is done with kt - 1
    if (kt + 1 < ktiles) load_tile((kt + 1) * FBK, cur ^ 1);
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = n0 + h * 64 + tx * 4;
      float* o = out + static_cast<size_t>(gr) * N + gc;
      if (vec_out && gc + 4 <= N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
        for (int j = 0; j < 4; ++j)
          if (gc + j < N) o[j] = acc[i][h * 4 + j];
      }
    }
  }
}

template <int V>
cudaError_t launch_f32(const void* x, const void* y, void* out, int m, int n,
                       int k, cudaStream_t st) {
  dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
  mm_f32_kernel<V><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(y),
                                             static_cast<float*>(out), m, n, k);
  return cudaGetLastError();
}


// ------------------------------------------------------------------------
// bf16: wgmma fed by a TMA producer through a ring of swizzled stages
// ------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BK = 64;
constexpr int kConsumers = 256;

// One instantiation: TN output columns (256 or 128), PER_SM CTAs on each
// SM.  Shared memory (after up to 1 KB that aligns it): a ring of kStages
// stages of (x's tile, y's tile), then the full and empty mbarriers.  A
// tile is COLS / 64 swizzle atoms of ROWS rows x 128 bytes, one after the
// other: x's 128 x 64 (K-major, one atom) or 64 x 128 (MN-major, two), y's
// TN x 64 or 64 x TN.  128 x 256: one CTA per SM, 4 stages and a producer
// warpgroup whose registers go to the consumers (40 / 232 of 168 at
// launch; ptxas keeps every thread within the launch's 168).  128 x 128:
// two CTAs per SM (one's loads and MMAs beside the other's epilogue), 3
// stages and a producer warp, so that 2 x 288 threads have the 112
// registers an m64n128 MMA's 64 accumulators need.
template <int TN>
struct Cfg {
  static constexpr int PER_SM = TN == 256 ? 1 : 2;
  static constexpr int kThreads = kConsumers + (PER_SM == 1 ? 128 : 32);
  static constexpr int kStages = PER_SM == 1 ? 4 : 3;
  static constexpr int kA = BM * BK * 2;
  static constexpr int kStage = kA + TN * BK * 2;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kSmem = 1024 + kBars + 16 * kStages;
  static_assert(PER_SM * kSmem <= 232448, "shared memory of one SM");
  static_assert(128 * 40 + kConsumers * 232 <= 168 * (kConsumers + 128),
                "setmaxnreg within the registers of the CTA");
  static_assert(2 * 64 * TN * 2 <= kBars, "the epilogue's staging within the ring");
};

// the box of `map` at (column c0, row r0) into shared address `dst`; its
// bytes complete a transaction of mbarrier `bar`; boxes past the matrix
// are zero-filled
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int c0, int r0,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_shared(unsigned addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// d (64 x TN) += a b over 16 of K: x's tile K-major (TA 0) or MN-major (1),
// y's likewise (TB)
template <int TN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[TN / 2], uint64_t a, uint64_t b,
                                    int accumulate) {
  if constexpr (TN == 256) wgmma_m64n256_ss<TA, TB>(d, a, b, accumulate);
  else wgmma_m64n128_ss<TA, TB>(d, a, b, accumulate);
}

template <int V, int TN>
__global__ void __launch_bounds__(Cfg<TN>::kThreads, Cfg<TN>::PER_SM)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmy,
                const bf16* __restrict__ x, const bf16* __restrict__ y,
                bf16* __restrict__ out, int M, int N, int K, int group) {
  using C = Cfg<TN>;
  constexpr int kStages = C::kStages, PER_SM = C::PER_SM;
  constexpr bool A_K = V != kTN;  // x's rows run along K
  constexpr bool B_K = V == kNT;  // y's rows run along K
  extern __shared__ unsigned char smem[];
  const unsigned base = (smem_addr(smem) + 1023) & ~1023u, bars = base + C::kBars;
  auto stage = [&](int n) { return base + (n % kStages) * C::kStage; };
  auto full = [&](int n) { return bars + 8 * (n % kStages); };
  auto empty = [&](int n) { return bars + 8 * kStages + 8 * (n % kStages); };
  const int tid = threadIdx.x;

  // the CTA's output tile: bands of `group` tile-rows, walked column by
  // column, each column's tile-rows in turn
  const int tiles_n = (N + TN - 1) / TN;
  const int band = blockIdx.x / (group * tiles_n), in_band = blockIdx.x % (group * tiles_n);
  const int rows = min((M + BM - 1) / BM - band * group, group);
  const int m0 = (band * group + in_band % rows) * BM, n0 = (in_band / rows) * TN;
  const int ktiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);   // the TMA thread's arrive, then the boxes' bytes
      mbar_init(empty(s), 8);  // every consumer warp done with it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: K-tile n into stage n % kStages once every consumer
    // warp has released K-tile n - kStages
    if constexpr (PER_SM == 1) setmaxnreg_dec<40>();
    // one thread asks the TMA for the stage's boxes of 64 columns (128
    // bytes, in the stage's swizzle atoms) and their bytes
    if (tid == kConsumers) {
      for (int n = 0; n < ktiles; ++n) {
        if (n >= kStages) mbar_wait(empty(n), ((n / kStages) & 1) ^ 1);
        const unsigned sa = stage(n), sb = sa + C::kA;
        const int k0 = n * BK;
        mbar_expect_tx(full(n), C::kStage);
        if constexpr (A_K) {
          tma_load(sa, &tmx, k0, m0, full(n));
        } else {
#pragma unroll
          for (int a = 0; a < BM / 64; ++a) tma_load(sa + a * 8192, &tmx, m0 + 64 * a, k0, full(n));
        }
        if constexpr (B_K) {
          tma_load(sb, &tmy, k0, n0, full(n));
        } else {
#pragma unroll
          for (int a = 0; a < TN / 64; ++a) tma_load(sb + a * 8192, &tmy, n0 + 64 * a, k0, full(n));
        }
      }
    }
  } else {
    if constexpr (PER_SM == 1) setmaxnreg_inc<232>();
    const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    float acc[TN / 2];
    for (int n = 0; n < ktiles; ++n) {
      mbar_wait(full(n), (n / kStages) & 1);
      // this warpgroup's 64 rows: 64 rows of x's K-major atom or x's n-th
      // MN-major atom, both 8 KB on; 16 of K is 32 bytes along a K-major
      // row and 16 rows (2 KB) of an MN-major atom
      const unsigned sa = stage(n) + wgi * 8192, sb = stage(n) + C::kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = A_K ? desc_sw128(sa + 32 * kk, 16, 1024)
                                : desc_sw128(sa + 2048 * kk, 8192, 1024);
        const uint64_t db = B_K ? desc_sw128(sb + 32 * kk, 16, 1024)
                                : desc_sw128(sb + 2048 * kk, 8192, 1024);
        mma<TN, A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db, n > 0 || kk > 0);
      }
      wgmma_commit();
      // K-tile n - 1's MMAs have retired: release its stage, if the
      // producer will refill it
      wgmma_wait<1>();
      if (n > 0 && n - 1 + kStages < ktiles && lane == 0) mbar_arrive(empty(n - 1));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // The epilogue.  Once both warpgroups are done with the ring, each
    // stages its 64 x TN bf16 rows there, in TN / 64 swizzle atoms (bf16
    // pairs from the accumulator layout: rows 16 warp + lane / 4 (+ 8),
    // columns 8 j + 2 (lane % 4) (+ 1)), then stores them as 16-byte chunks
    // of whole rows, predicated at the M and N edges
    named_sync(1, kConsumers);
    const unsigned so = base + wgi * (64 * TN * 2);
    const int r = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st_shared(so + (j / 8) * 8192 + (r + 8 * h) * 128 + (((j % 8) ^ (r & 7)) << 4) +
                      4 * (lane % 4),
                  pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    if (wgi == 0) named_sync(2, 128);  // constant ids: ptxas counts the barriers used
    else named_sync(3, 128);
    const int t = tid % 128, wm0 = m0 + 64 * wgi;
    const bool whole = N % 8 == 0;
#pragma unroll 4
    for (int jj = 0; jj < 64 * TN / 8 / 128; ++jj) {
      const int i = t + 128 * jj, row = i / (TN / 8), c = i % (TN / 8);
      const int gr = wm0 + row, gc = n0 + 8 * c;
      if (gr >= M || gc >= N) continue;
      const uint4 v = ld_shared16(so + (c / 8) * 8192 + row * 128 + (((c % 8) ^ (row & 7)) << 4));
      bf16* o = out + static_cast<size_t>(gr) * N + gc;
      if (whole) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (gc + q < N) o[q] = __ushort_as_bfloat16(static_cast<unsigned short>(w[q / 2] >> (16 * (q % 2))));
      }
    }
  }
}

// The TMA map of a row-major (rows, cols) bf16 matrix in boxes of 64
// columns x box_rows rows, 128-byte swizzled, zeros past its edges
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const sm90::Encode encode = sm90::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int V, int TN>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n, int k, int group,
                   cudaStream_t st) {
  using C = Cfg<TN>;
  // x's boxes: 128 rows of 64 of K, or 64 rows of K (twice); y's: TN rows
  // of 64 of K, or 64 rows of K (TN / 64 times)
  CUtensorMap tmx, tmy;
  const bool a_k = V != kTN, b_k = V == kNT;
  if (!tensor_map(&tmx, x, a_k ? m : k, a_k ? k : m, a_k ? BM : BK) ||
      !tensor_map(&tmy, y, b_k ? n : k, b_k ? k : n, b_k ? TN : BK))
    return cudaErrorInvalidValue;
  auto kernel = mm_wgmma_kernel<V, TN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>((m + BM - 1) / BM) * ((n + TN - 1) / TN);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ctas), C::kThreads, C::kSmem, st>>>(
      tmx, tmy, static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<bf16*>(out), m, n, k, group);
  return cudaGetLastError();
}

// The wgmma tile of `tile` output columns; the operands' contiguous
// dimensions must be multiples of 8 (kernels/matmul.py mm_plan's rule)
template <int V>
cudaError_t dispatch(const void* x, const void* y, void* out, int m, int n, int k, int tile,
                     int group, cudaStream_t st) {
  const int ax = V == kTN ? m : k, by = V == kNT ? k : n;
  if (ax % 8 != 0 || by % 8 != 0 || group < 1) return cudaErrorInvalidValue;
  if (tile == 256) return launch<V, 256>(x, y, out, m, n, k, group, st);
  if (tile == 128) return launch<V, 128>(x, y, out, m, n, k, group, st);
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

// out (m, n) = x @ y (variant 0: x (m, k), y (k, n)), x @ y^T (1: y (n, k))
// or x^T @ y (2: x (k, m)).  Every operand row-major, contiguous and
// 16-byte aligned, all three of one dtype: 0 = float32, 1 = bfloat16.
// tile: 0 for f32's FFMA tile or bf16's WMMA tile, 128 or 256 for the bf16
// wgmma tile of that many output columns, whose CTAs walk bands of `group`
// tile-rows (kernels/matmul.py mm_plan).  Built with -DMM_WMMA_BF16, every
// bf16 product runs the WMMA tile (chip_smoke.py's A/B).  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a bad variant, dtype,
// tile or size).
extern "C" int matmul(const void* x, const void* y, void* out, int m, int n,
                      int k, int variant, int dtype, int tile, int group,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
#ifdef MM_WMMA_BF16
  tile = 0;
#endif
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && tile != 0) {
    if (variant == kNN) err = wg::dispatch<kNN>(x, y, out, m, n, k, tile, group, st);
    if (variant == kNT) err = wg::dispatch<kNT>(x, y, out, m, n, k, tile, group, st);
    if (variant == kTN) err = wg::dispatch<kTN>(x, y, out, m, n, k, tile, group, st);
  } else if (dtype == 1) {
    if (variant == kNN) err = dispatch_bf16<kNN>(x, y, out, m, n, k, st);
    if (variant == kNT) err = dispatch_bf16<kNT>(x, y, out, m, n, k, st);
    if (variant == kTN) err = dispatch_bf16<kTN>(x, y, out, m, n, k, st);
  } else if (dtype == 0 && tile == 0) {
    if (variant == kNN) err = launch_f32<kNN>(x, y, out, m, n, k, st);
    if (variant == kNT) err = launch_f32<kNT>(x, y, out, m, n, k, st);
    if (variant == kTN) err = launch_f32<kTN>(x, y, out, m, n, k, st);
  }
  return static_cast<int>(err);
}
