// RMSNorm and fused residual-add + RMSNorm, forward and backward, for
// sm_90a.
//
// Replaces minidiff_tpu/kernels/layernorm.py:
//   rms_fwd    <- _rms_fwd_kernel    (:91,  pallas_call in _pallas_rms_fwd)
//   addrms_fwd <- _addrms_fwd_kernel (:141, pallas_call in _pallas_addrms_fwd)
//   rms_bwd    <- _rms_bwd_kernel    (:112, pallas_call in _pallas_rms_bwd)
//   addrms_bwd <- _addrms_bwd_kernel (:168, pallas_call in _pallas_addrms_bwd)
//
// Semantics (the JAX module's contract): statistics in f32 for bf16 inputs,
// y = x * rsqrt(mean(x^2) + eps) * g cast back to x's dtype.  addrms_fwd
// forms t = x + a in the MODEL dtype (bf16 rounding) before the f32
// statistics and writes both t and RMSNorm(t), so its outputs equal an
// unfused add followed by rms_fwd bit for bit.  Backward, with xhat =
// x * rsig and w = dy * g (rsig recomputed in f32 from x):
//   dx = (w - xhat * mean(w * xhat)) * rsig           cast to x's dtype
//   dg = sum_rows(dy * xhat)
// addrms_bwd rounds that dx to the model dtype and then adds the residual
// cotangent g0 in the model dtype (two roundings, as :176-177).
//
// Bound on the H100: bytes.  Each row is read once and written once (x and
// y; x, a, t and y for the add; x, dy, dx and g0 for the backward) against
// about 5-12 flops per element.  Design: one thread block per row
// (rowblock.cuh), because the model's rows (d = 4096 at Mistral-7B width,
// up to 8192) do not fit one warp's registers: a 4096-wide f32 row would
// need 128 registers a lane for x alone.  A block of up to 256 threads
// holds the row in registers instead, so x still crosses device memory
// once; a row statistic costs one block reduction (two shared-memory
// barriers).  The backward writes per-block f32 dg partial rows that the
// caller sums, as ln_bwd does.  At a decode step's 8 rows the launch is
// latency-bound: rms_fwd and addrms_fwd there take rowblock.cuh's
// norm_wave_kernel, as their launch plan (kernels.layernorm.norm_fwd_plan)
// says, which fetches x, a (addrms) and g in one wave, stores t = x + a
// before its one exchange per row, where the block-per-row kernel loaded g
// only after its reduction's two barriers.
//
// rms_bwd runs rowblock.cuh's norm_ring_bwd_kernel at every row count, as
// its launch plan (kernels.layernorm.norm_bwd_plan) says: a persistent CTA
// whose thread 0 keeps the x and dy of the next rows in flight by TMA bulk
// copies into a ring of shared-memory stages, g read once into registers,
// and one exchange (one barrier) a row carrying both row sums, sum(x^2) and
// sum(dy g x).  The block-per-row kernel it replaces walked each row as a
// chain of two device-memory round trips and four barriers with nothing of
// the next row in flight.  Bound: bytes (x, dy read once, dx written
// once).  A build with -DNORM_BWD_V1 takes the block-per-row kernel for
// rms_bwd, as before the ring (chip_smoke.py times the two in turns);
// addrms_bwd keeps it in every build.

#include "rowblock.cuh"

namespace {

#ifdef NORM_BWD_V1
constexpr bool kBwdV1 = true;
#else
constexpr bool kBwdV1 = false;
#endif

// Replaces no TPU kernel: an empty kernel with the one-wave forward's
// parameters, which chip_smoke.py launches at each norm's grid and block
// to measure the least time a launch of that shape takes on the card (the
// floor beside every decode-row norm time).
__global__ void norm_null_kernel(const void*, const void*, const void*,
                                 const void*, void*, void*, int, float, float) {}

// The forward by the plan's (threads, vecs): vecs > 0 on rowblock.cuh's
// norm_wave_kernel, else (and on every row of a -DNORM_FWD_V1 build) a
// block per row.
template <typename T, bool ADD>
int launch(const void* x, const void* a, const void* g, void* t_out, void* y,
           int rows, int d, float eps, int threads, int vecs, void* stream) {
  if (vecs > 0 && !rowblock::kFwdV1)
    return rowblock::launch_wave<T, true, ADD>(x, a, g, nullptr, t_out, y, rows,
                                               d, eps, threads, vecs, stream);
  return rowblock::launch_fwd<T, true, ADD>(x, a, g, nullptr, t_out, y, rows, d,
                                            eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller has checked that every
// pointer is 16-byte aligned, d is a multiple of the vector width (8 bf16,
// 4 f32) and d <= 8192, and rows >= 1.  threads, vecs: the launch plan's
// (kernels.layernorm.norm_fwd_plan); vecs > 0 takes rowblock.cuh's
// norm_wave_kernel (refused unless they are its own configuration), 0 the
// block-per-row kernel, as does every row of a -DNORM_FWD_V1 build.
// Returns cudaGetLastError().
extern "C" int rms_fwd(const void* x, const void* g, void* y, int rows, int d,
                       float eps, int dtype, int threads, int vecs, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, nullptr, g, nullptr, y, rows, d, eps,
                                        threads, vecs, stream);
  return launch<float, false>(x, nullptr, g, nullptr, y, rows, d, eps, threads,
                              vecs, stream);
}

// out holds (2, rows, d): out[0] = x + a, out[1] = RMSNorm(x + a).
// threads, vecs: the launch plan's, routed as rms_fwd's.
extern "C" int addrms_fwd(const void* x, const void* a, const void* g,
                          void* out, int rows, int d, float eps, int dtype,
                          int threads, int vecs, void* stream) {
  const size_t n = static_cast<size_t>(rows) * d;
  if (dtype == 1) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    return launch<__nv_bfloat16, true>(x, a, g, o, o + n, rows, d, eps, threads,
                                       vecs, stream);
  }
  float* o = static_cast<float*>(out);
  return launch<float, true>(x, a, g, o, o + n, rows, d, eps, threads, vecs,
                             stream);
}

// dx like x; dgp (blocks, d) f32 partial rows, blocks >= 1.  threads,
// vecs, stages: the launch plan's (kernels.layernorm.norm_bwd_plan);
// stages > 0 takes rowblock.cuh's norm_ring_bwd_kernel over `blocks` CTAs
// (refused unless threads and vecs are its configuration for d and the
// stages fit), then sums the partial rows into dg (g's dtype); 0 takes the
// block-per-row kernel, whose partial rows the caller sums (dg unused), as
// does every row of a -DNORM_BWD_V1 build.
extern "C" int rms_bwd(const void* x, const void* g, const void* dy, void* dx,
                       void* dgp, void* dg, int rows, int d, int blocks, float eps,
                       int dtype, int threads, int vecs, int stages, void* stream) {
  if (stages > 0 && !kBwdV1) {
    if (dtype == 1)
      return rowblock::launch_ring<__nv_bfloat16, true, false>(
          x, g, dy, nullptr, dx, dgp, nullptr, dg, nullptr, rows, d, blocks, threads, vecs,
          stages, eps, stream);
    return rowblock::launch_ring<float, true, false>(x, g, dy, nullptr, dx, dgp, nullptr, dg,
                                                     nullptr, rows, d, blocks, threads, vecs,
                                                     stages, eps, stream);
  }
  if (dtype == 1)
    return rowblock::launch_bwd<__nv_bfloat16, true, false>(
        x, g, dy, nullptr, dx, dgp, nullptr, rows, d, blocks, eps, stream);
  return rowblock::launch_bwd<float, true, false>(
      x, g, dy, nullptr, dx, dgp, nullptr, rows, d, blocks, eps, stream);
}

// Whether this build has rms_bwd's ring (1), or only the block-per-row
// kernel (0: -DNORM_BWD_V1), which the wrapper then plans for.
extern "C" int rms_bwd_ring() { return kBwdV1 ? 0 : 1; }

// t = x + a as addrms_fwd wrote it; g0 the cotangent of t;
// dx = round(RMS_dx) + g0.
extern "C" int addrms_bwd(const void* t, const void* g, const void* dy,
                          const void* g0, void* dx, void* dgp, int rows, int d,
                          int blocks, float eps, int dtype, void* stream) {
  if (dtype == 1)
    return rowblock::launch_bwd<__nv_bfloat16, true, true>(
        t, g, dy, g0, dx, dgp, nullptr, rows, d, blocks, eps, stream);
  return rowblock::launch_bwd<float, true, true>(
      t, g, dy, g0, dx, dgp, nullptr, rows, d, blocks, eps, stream);
}

// The empty kernel at a grid of ctas and blocks of threads.
extern "C" int norm_null(int ctas, int threads, void* stream) {
  norm_null_kernel<<<ctas, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0.f, 0.f);
  return static_cast<int>(cudaGetLastError());
}
