// LayerNorm and fused residual-add + LayerNorm, forward and backward, for
// sm_90a.
//
// Replaces minidiff_tpu/kernels/layernorm.py:
//   ln_fwd    <- _fwd_kernel       (:84,  pallas_call in _pallas_ln_fwd)
//   addln_fwd <- _addln_fwd_kernel (:123, pallas_call in _pallas_addln_fwd)
//   ln_bwd    <- _bwd_kernel       (:181, pallas_call in _pallas_ln_bwd)
//   addln_bwd <- _addln_bwd_kernel (:149, pallas_call in _pallas_addln_bwd)
//
// Semantics (the JAX module's contract): statistics in f32 for bf16 inputs,
// biased variance of the centred row, y = (x-mu)*rsqrt(var+eps)*g + b cast
// back to x's dtype.  addln_fwd forms t = x + a in the MODEL dtype (bf16
// rounding) before the f32 statistics and writes both t and LN(t), so its
// outputs equal an unfused add followed by ln_fwd bit for bit.
//
// Bound on the H100: bytes.  A row of d elements is read once and written
// once (twice for addln), against ~8 flops per element: three orders of
// magnitude under the ~295 flop/byte ridge.  Design: one warp per row, so
// both reductions are warp shuffles with no shared memory or block barrier;
// each lane moves 16-byte vectors (8 bf16 or 4 f32) from neighbouring
// addresses, and the row stays in registers between the mean pass, the
// centred-variance pass and the output pass, so x crosses HBM exactly once.
// At the decode path's 8 rows the launch is latency-bound; fusing it into
// its neighbours is later work.
//
// Backward, with xhat = (x-mu)*rsig and w = dy*g (statistics recomputed in
// f32 from x, as _bwd_kernel calls _stats):
//   dx = (w - mean(w) - xhat*mean(w*xhat)) * rsig      cast to x's dtype
//   dg = sum_rows(dy*xhat),  db = sum_rows(dy)
// addln_bwd rounds that dx to the model dtype and then adds the residual
// cotangent g0 in the model dtype (two roundings, as :162-163).  Bound:
// bytes again (x, dy, dx, and g0 for addln, once each).  Design: one warp
// per row as in the forward; a lane owns the same columns in every row, so
// it keeps its dg/db sums in registers while its warp walks a run of rows;
// the block's warps then add theirs through shared memory and write one f32
// partial row per block.  The caller sums the partials (as _pallas_ln_bwd
// sums its strips outside the kernel): no atomics, so the result is the
// same on every run.  The register arrays are sized per launch (NV vectors
// per lane) so that d = 1024 does not pay for the widest row.
//
// Rows wider than one warp's registers hold (kWarpRowWidth: 2,048 bf16 or
// 1,024 f32 values) go to the block-per-row kernels of rowblock.cuh, which
// rmsnorm.cu shares, up to the JAX kernels' d <= 8192.  A build with
// -DNORM_BLOCK_PER_ROW sends every row there (chip_smoke.py times the two
// routes against each other at the flagship's widths).
//
// ln_fwd and addln_fwd at decode-sized row counts take rowblock.cuh's
// norm_wave_kernel instead, as their launch plan
// (kernels.layernorm.norm_fwd_plan) says: one CTA per row, x, a (addln),
// g and b fetched in one wave, t = x + a stored before the row's one
// exchange.  The warp-per-row kernel's serial chain (x, then a, two
// dependent shuffle reductions, only then g and b) made it slower at 8
// rows of 1,024 than rms_fwd at 8 rows of 4,096.
//
// ln_bwd and addln_bwd take rowblock.cuh's norm_ring_bwd_kernel at every
// row count, as their launch plan (kernels.layernorm.norm_bwd_plan) says:
// persistent CTAs whose thread 0 keeps the x and dy rows (and addln's g0
// row: three a stage) of the next rows in flight by TMA bulk copies into a
// ring of shared-memory stages, g read once into registers, and one
// exchange (one barrier) a row carrying all four row sums (the mean, the
// centred sum of squares, sum(w) and sum(w (x - mean))) as parts merged by
// norm_wave_kernel's k-part formula; the partial rows of dg and db are
// summed in a fixed order by a second launch.  The kernels above walked
// each row as a chain (x, two dependent reductions, only then dy and g, two
// more, g again, then dx) with nothing of the next row in flight, and left
// the partial rows' sum to two PyTorch kernels.  Bound: bytes (x, dy and
// g0 read once, dx written once).  A build with -DNORM_BWD_V1 keeps the
// warp-per-row and block-per-row backwards for both, as before the ring
// (chip_smoke.py times the two in turns).

#include "rowblock.cuh"

namespace {

using rowwise::Vec;
using rowwise::warp_sum;

#ifdef NORM_BLOCK_PER_ROW
constexpr bool kBlockPerRow = true;
#else
constexpr bool kBlockPerRow = false;
#endif

#ifdef NORM_BWD_V1
constexpr bool kBwdV1 = true;
#else
constexpr bool kBwdV1 = false;
#endif

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxVecsPerLane = 8;  // d <= 32 * 8 * VEC (2048 bf16, 1024 f32)

// the widest row of the warp-per-row kernels
template <typename T>
constexpr int kWarpRowWidth = 32 * kMaxVecsPerLane * Vec<T>::N;

// One warp per row.  ADD: x <- round_T(x + a), written to t, then normalised.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ a,
               const T* __restrict__ g, const T* __restrict__ b,
               T* __restrict__ t_out, T* __restrict__ y, int rows, int d,
               float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / V;
  const size_t base = static_cast<size_t>(row) * d;

  float v[kMaxVecsPerLane][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      Vec<T>::load(x + base + c * V, v[i]);
      if (ADD) {
        float av[V];
        Vec<T>::load(a + base + c * V, av);
#pragma unroll
        for (int j = 0; j < V; ++j) v[i][j] = Vec<T>::round(v[i][j] + av[j]);
        Vec<T>::store(t_out + base + c * V, v[i]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i][j];
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const float mu = warp_sum(sum) * inv_d;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecsPerLane; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] -= mu;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rsig = rsqrtf(warp_sum(sq) * inv_d + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float gv[V], bv[V];
      Vec<T>::load(g + c * V, gv);
      Vec<T>::load(b + c * V, bv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = v[i][j] * rsig * gv[j] + bv[j];
      Vec<T>::store(y + base + c * V, v[i]);
    }
  }
}

// The forward by the plan's (threads, vecs): vecs > 0 on rowblock.cuh's
// norm_wave_kernel, else (and on every row of a -DNORM_FWD_V1 or
// -DNORM_BLOCK_PER_ROW build) a warp per row or a block per row.
template <typename T, bool ADD>
int launch(const void* x, const void* a, const void* g, const void* b,
           void* t_out, void* y, int rows, int d, float eps, int threads,
           int vecs, void* stream) {
  if (vecs > 0 && !rowblock::kFwdV1 && !kBlockPerRow)
    return rowblock::launch_wave<T, false, ADD>(x, a, g, b, t_out, y, rows, d,
                                                eps, threads, vecs, stream);
  if (kBlockPerRow || d > kWarpRowWidth<T>)
    return rowblock::launch_fwd<T, false, ADD>(x, a, g, b, t_out, y, rows, d,
                                               eps, stream);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_rows_kernel<T, ADD><<<blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(t_out), static_cast<T*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdWarps = 8;

// Block b takes rows [b*rows_per_block, (b+1)*rows_per_block); its warps
// take every kBwdWarps-th row of that run.  ADD: dx = round_T(dx) + g0.
// dgp/dbp: (gridDim.x, d) f32 partials.  Shared memory: kBwdWarps * d f32.
template <typename T, int NV, bool ADD>
__global__ void __launch_bounds__(kBwdWarps * 32)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              const T* __restrict__ dy, const T* __restrict__ g0,
              T* __restrict__ dx, float* __restrict__ dgp,
              float* __restrict__ dbp, int rows, int d, int rows_per_block,
              float eps) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float red[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d / V;
  const float inv_d = 1.f / static_cast<float>(d);

  float dg_acc[NV][V], db_acc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) dg_acc[i][j] = db_acc[i][j] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += kBwdWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    float xv[NV][V], dv[NV][V];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        Vec<T>::load(x + base + c * V, xv[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) sum += xv[i][j];
      }
    }
    const float mu = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xv[i][j] -= mu;
          sq += xv[i][j] * xv[i][j];
        }
      }
    }
    const float rsig = rsqrtf(warp_sum(sq) * inv_d + eps);

    // xv becomes xhat; sums of w and w*xhat; this lane's dg, db columns
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float gv[V];
        Vec<T>::load(dy + base + c * V, dv[i]);
        Vec<T>::load(g + c * V, gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = xv[i][j] * rsig;
          const float w = dv[i][j] * gv[j];
          xv[i][j] = xh;
          s1 += w;
          s2 += w * xh;
          dg_acc[i][j] += dv[i][j] * xh;
          db_acc[i][j] += dv[i][j];
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(s2) * inv_d;

#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float gv[V], o[V];
        Vec<T>::load(g + c * V, gv);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = (dv[i][j] * gv[j] - m1 - xv[i][j] * m2) * rsig;
        if (ADD) {
          float g0v[V];
          Vec<T>::load(g0 + base + c * V, g0v);
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = Vec<T>::round(o[j]) + g0v[j];
        }
        Vec<T>::store(dx + base + c * V, o);
      }
    }
  }

  // this block's partial dg, then db: every warp's columns through shared
  // memory, summed over the warps in a fixed order
  float* outs[2] = {dgp, dbp};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          red[warp * d + c * V + j] = which == 0 ? dg_acc[i][j] : db_acc[i][j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kBwdWarps * 32) {
      float s = 0.f;
      for (int w = 0; w < kBwdWarps; ++w) s += red[w * d + c];
      outs[which][static_cast<size_t>(blockIdx.x) * d + c] = s;
    }
    __syncthreads();
  }
}

template <typename T, int NV, bool ADD>
int launch_bwd(const void* x, const void* g, const void* dy, const void* g0,
               void* dx, void* dgp, void* dbp, int rows, int d, int blocks,
               float eps, void* stream) {
  const int smem = kBwdWarps * d * static_cast<int>(sizeof(float));
  auto kernel = ln_bwd_kernel<T, NV, ADD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows_per_block = (rows + blocks - 1) / blocks;
  kernel<<<blocks, kBwdWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(dy), static_cast<const T*>(g0),
      static_cast<T*>(dx), static_cast<float*>(dgp), static_cast<float*>(dbp),
      rows, d, rows_per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

// The widest row of the warp-per-row backward: 1,024 values in either
// dtype.  A bf16 lane of 8 vectors (d up to 2,048) held x, dy and the dg /
// db sums in 255 registers and spilled 356 bytes; those rows go to the
// block-per-row kernel, as the wider ones do.
constexpr int kBwdWarpRowWidth = 1024;

// The backward by the plan's (threads, vecs, stages): stages > 0 on
// rowblock.cuh's ring (which sums dg and db from its partial rows), else
// (and on every row of a -DNORM_BWD_V1 build) the smallest register width
// (vectors per lane) of the warp-per-row kernel that holds the row, or the
// block-per-row kernel for wider rows, whose partial rows the caller sums.
template <typename T, bool ADD>
int dispatch_bwd(const void* x, const void* g, const void* dy, const void* g0,
                 void* dx, void* dgp, void* dbp, void* dg, void* db, int rows, int d,
                 int blocks, float eps, int threads, int vecs, int stages, void* stream) {
  if (stages > 0 && !kBwdV1)
    return rowblock::launch_ring<T, false, ADD>(x, g, dy, g0, dx, dgp, dbp, dg, db, rows, d,
                                                blocks, threads, vecs, stages, eps, stream);
  if (kBlockPerRow || d > kBwdWarpRowWidth)
    return rowblock::launch_bwd<T, false, ADD>(x, g, dy, g0, dx, dgp, dbp, rows,
                                               d, blocks, eps, stream);
  const int per_lane = (d / Vec<T>::N + 31) / 32;
  if (per_lane <= 1)
    return launch_bwd<T, 1, ADD>(x, g, dy, g0, dx, dgp, dbp, rows, d, blocks, eps, stream);
  if (per_lane <= 2)
    return launch_bwd<T, 2, ADD>(x, g, dy, g0, dx, dgp, dbp, rows, d, blocks, eps, stream);
  constexpr int widest = kBwdWarpRowWidth / (32 * Vec<T>::N);  // 4 bf16, 8 f32
  if (widest == 4 || per_lane <= 4)
    return launch_bwd<T, 4, ADD>(x, g, dy, g0, dx, dgp, dbp, rows, d, blocks, eps, stream);
  return launch_bwd<T, widest, ADD>(x, g, dy, g0, dx, dgp, dbp, rows, d, blocks, eps,
                                    stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller has checked that every
// pointer is 16-byte aligned, d is a multiple of the vector width (8 bf16,
// 4 f32) and d <= 8192, and rows >= 1.  threads, vecs: the launch plan's
// (kernels.layernorm.norm_fwd_plan); vecs > 0 takes rowblock.cuh's
// norm_wave_kernel (refused unless they are its own configuration), 0 the
// routes above, as does every row of a -DNORM_FWD_V1 or
// -DNORM_BLOCK_PER_ROW build.  Returns cudaGetLastError().
extern "C" int ln_fwd(const void* x, const void* g, const void* b, void* y,
                      int rows, int d, float eps, int dtype, int threads,
                      int vecs, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, nullptr, g, b, nullptr, y, rows, d,
                                        eps, threads, vecs, stream);
  return launch<float, false>(x, nullptr, g, b, nullptr, y, rows, d, eps,
                              threads, vecs, stream);
}

// out holds (2, rows, d): out[0] = x + a, out[1] = LN(x + a).  threads,
// vecs: the launch plan's, routed as ln_fwd's.
extern "C" int addln_fwd(const void* x, const void* a, const void* g,
                         const void* b, void* out, int rows, int d, float eps,
                         int dtype, int threads, int vecs, void* stream) {
  const size_t n = static_cast<size_t>(rows) * d;
  if (dtype == 1) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    return launch<__nv_bfloat16, true>(x, a, g, b, o, o + n, rows, d, eps,
                                       threads, vecs, stream);
  }
  float* o = static_cast<float*>(out);
  return launch<float, true>(x, a, g, b, o, o + n, rows, d, eps, threads, vecs,
                             stream);
}

// dx like x; dgp and dbp (blocks, d) f32 partial rows, blocks >= 1; dg and
// db like g.  threads, vecs, stages: the launch plan's
// (kernels.layernorm.norm_bwd_plan); stages > 0 takes rowblock.cuh's
// norm_ring_bwd_kernel over `blocks` CTAs (refused unless threads and vecs
// are its configuration for d and the stages fit), then sums the partial
// rows into dg and db (g's dtype); 0 takes the warp-per-row or
// block-per-row kernel, whose partial rows the caller sums (dg and db
// unused), as does every row of a -DNORM_BWD_V1 build.  Same pointer,
// dtype and width conditions as ln_fwd.
extern "C" int ln_bwd(const void* x, const void* g, const void* dy, void* dx,
                      void* dgp, void* dbp, void* dg, void* db, int rows, int d,
                      int blocks, float eps, int dtype, int threads, int vecs, int stages,
                      void* stream) {
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16, false>(x, g, dy, nullptr, dx, dgp, dbp, dg, db,
                                              rows, d, blocks, eps, threads, vecs, stages,
                                              stream);
  return dispatch_bwd<float, false>(x, g, dy, nullptr, dx, dgp, dbp, dg, db, rows, d,
                                    blocks, eps, threads, vecs, stages, stream);
}

// t = x + a as addln_fwd wrote it; g0 the cotangent of t;
// dx = round(LN_dx) + g0.  Launched as ln_bwd.
extern "C" int addln_bwd(const void* t, const void* g, const void* dy,
                         const void* g0, void* dx, void* dgp, void* dbp, void* dg,
                         void* db, int rows, int d, int blocks, float eps, int dtype,
                         int threads, int vecs, int stages, void* stream) {
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16, true>(t, g, dy, g0, dx, dgp, dbp, dg, db, rows,
                                             d, blocks, eps, threads, vecs, stages,
                                             stream);
  return dispatch_bwd<float, true>(t, g, dy, g0, dx, dgp, dbp, dg, db, rows, d, blocks,
                                   eps, threads, vecs, stages, stream);
}

// Whether this build has the backwards' ring (1), or only the warp-per-row
// and block-per-row kernels (0: -DNORM_BWD_V1), which the wrapper then
// plans for.
extern "C" int ln_bwd_ring() { return kBwdV1 ? 0 : 1; }
