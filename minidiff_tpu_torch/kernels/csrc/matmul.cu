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
// bf16 design: tensor cores through WMMA 16x16x16 (mma.sync underneath),
// f32 accumulators in registers.  One CTA of 8 warps per 128x128 output
// tile, each warp a 64x32 sub-tile (4x2 fragments).  K advances in steps of
// 32 through a 3-stage ring of shared-memory tiles filled with cp.async
// (16-byte copies, zero-filled past the edges), so two tiles' loads are in
// flight while the third is multiplied.  A tile keeps its operand's global
// layout (rows of K for x in nn/nt and y in nt, rows of M or N otherwise)
// and WMMA reads it as row- or column-major: that is the whole difference
// between the three variants.  Rows are padded by 8 bf16 so that the
// fragment loads hit distinct banks.  When a contiguous dimension is not a
// multiple of 8 (a 16-byte copy would straddle a row) the tiles are filled
// by plain predicated loads instead.  The epilogue stages each f32
// fragment through shared memory (a WMMA fragment does not say which
// element it holds) and writes bf16 rows of 16 bytes.
//
// f32 design: FFMA on the CUDA cores with full f32 products (TF32 would
// break the f32 contract).  One CTA of 256 threads per 128x128 tile, each
// thread an 8x8 register tile (two 4-row by two 4-column blocks, so that
// the shared-memory reads are conflict-free float4s), K in steps of 8,
// double-buffered through registers: the next tile's global loads are in
// flight while the current one is multiplied.  Both operands sit in shared
// memory as [k][m] and [k][n]; a K-contiguous operand is transposed on its
// way in (rows padded by 4 floats, so the transposed stores hit distinct
// banks).
//
// wgmma, TMA, warp specialization and a persistent tile schedule are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kNN = 0, kNT = 1, kTN = 2;

// ------------------------------------------------------------------------
// bf16: WMMA tensor cores
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
      cp_async16(dst + r * T::LD + c, g, in ? 16 : 0);
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
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    cp_async_commit();

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
  cp_async_wait<0>();
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
  constexpr int kPer = FBK * FBM / kThreads;  // elements each thread loads
  float ra[kPer], rb[kPer];

  // element e of a tile as (k, m): along K first for a K-contiguous
  // operand, along M (N) first otherwise, so that a warp reads neighbours
  auto load_regs = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int ka = A_K ? e % FBK : e / FBM, ma = A_K ? e / FBK : e % FBM;
      const int gk = k0 + ka, gm = m0 + ma;
      ra[i] = (gk < K && gm < M)
                  ? x[A_K ? static_cast<size_t>(gm) * K + gk : static_cast<size_t>(gk) * M + gm]
                  : 0.f;
      const int kb = B_K ? e % FBK : e / FBN, nb = B_K ? e / FBK : e % FBN;
      const int hk = k0 + kb, gn = n0 + nb;
      rb[i] = (hk < K && gn < N)
                  ? y[B_K ? static_cast<size_t>(gn) * K + hk : static_cast<size_t>(hk) * N + gn]
                  : 0.f;
    }
  };
  auto store_regs = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      As[buf][A_K ? e % FBK : e / FBM][A_K ? e / FBK : e % FBM] = ra[i];
      Bs[buf][B_K ? e % FBK : e / FBN][B_K ? e / FBK : e % FBN] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (K + FBK - 1) / FBK;
  load_regs(0);
  store_regs(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load_regs((kt + 1) * FBK);
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
    // the other buffer was last read before the previous barrier
    if (kt + 1 < ktiles) store_regs(cur ^ 1);
    __syncthreads();
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

}  // namespace

// out (m, n) = x @ y (variant 0: x (m, k), y (k, n)), x @ y^T (1: y (n, k))
// or x^T @ y (2: x (k, m)).  Every operand row-major, contiguous and
// 16-byte aligned, all three of one dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a bad
// variant, dtype or size).
extern "C" int matmul(const void* x, const void* y, void* out, int m, int n,
                      int k, int variant, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (variant == kNN) err = dispatch_bf16<kNN>(x, y, out, m, n, k, st);
    if (variant == kNT) err = dispatch_bf16<kNT>(x, y, out, m, n, k, st);
    if (variant == kTN) err = dispatch_bf16<kTN>(x, y, out, m, n, k, st);
  } else if (dtype == 0) {
    if (variant == kNN) err = launch_f32<kNN>(x, y, out, m, n, k, st);
    if (variant == kNT) err = launch_f32<kNT>(x, y, out, m, n, k, st);
    if (variant == kTN) err = launch_f32<kTN>(x, y, out, m, n, k, st);
  }
  return static_cast<int>(err);
}
