// First-order linear recurrence for sm_90a: y_t = a_t * y_{t-1} + b_t along
// T, with y_{-1} = 0, over (lead, T, C) contiguous operands; and its reverse,
// r_t = a_{t+1} * r_{t+1} + b_t walking t from T-1 down to 0, with r_T = 0
// and the decay past the end (a_T) exactly 0.
//
// Replaces minidiff_tpu/kernels/scan.py _scan_kernel (:67), reached through
// _pallas_scan (pallas_call at :83).  Same contract: f32 or bf16 operands,
// the carry in f32, each output rounded once to the stored dtype (the carry
// itself is never rounded).  The op's VJPs are reversed linear scans
// (ops/definitions.py:487-561): the reverse mode computes the cotangent
// flip(scan(shift(flip(a)), flip(g))) with the same two rounded operations
// in the same order, so the same bits, without the flips and the shift.
//
// Bound on the H100: one multiply-add per element, so a, b and y crossing
// HBM once each bound it: 3 x lead x T x C elements over 3.35 TB/s (at the
// train step's (8, 1024, 32768) bf16, 1.61 GB in 0.481 ms; at a server
// slot's one-row prefill (1, 384, 32768), 75.5 MB in 22.5 us).
//
// Each step is a rounded multiply, then a rounded add (__fmul_rn, __fadd_rn:
// never contracted into one FMA), the plain version's two f32 operations in
// its order, so the two agree bit for bit.  The channels are the
// parallelism: the chain along T is short (~8 cycles a step), and what
// bounds the kernel is keeping enough of a and b in flight.
//
// The ring kernel (scan_ring_kernel; kernels.scan.scan_plan sends rows of
// whole 16-byte runs and enough steps to it, by shape, before launch).  A
// CTA takes one lead row and a tile of `tile` channels (two a consumer
// thread), and walks T in stages of STEPS steps through a ring of `stages`
// shared-memory slots, each [a: STEPS x tile | b: STEPS x tile].  One lane
// of a producer warp fills the ring ahead of the chain: for each stage one
// 3-D TMA tensor copy of a and one of b (the box of STEPS steps x tile
// channels of the lead row, zeros past T and C), completing the slot's
// full mbarrier.  The consumer warps wait on it, read the stage's steps
// into registers, release the slot through its empty mbarrier (one
// arrival a warp) so that it refills during their chain, and store y
// straight to device memory.  With the ring a CTA keeps (stages - 1) x
// STEPS steps of its tile in flight whatever the lead, where the thread
// kernel below keeps kUnroll steps of each thread's two channels: at lead 1
// and C 32,768 that was 16,384 threads on 64 SMs and ~1 MB in flight, a
// third of what the card's bandwidth x latency needs; the ring's 256-channel
// tiles put one CTA on each of 128 SMs.  One copy a stage, not one a step's
// row: copies of a row of 512 bytes each were the first ring's limit.
// Reverse: stage k holds steps [lo, lo + n) counted from the end, b from
// step lo and the decays a_{t+1} from step lo + 1, so the chain never
// crosses a stage; the last step's decay is taken as 0.
//
// The thread kernel (scan_kernel): one thread owns one (lead row, channel
// pair) -- two adjacent channels as one float2 or __nv_bfloat162 when C is
// even, one channel otherwise -- and walks T with its carry in registers,
// the loads of kUnroll steps issued before the dependent chain that
// consumes them.  It takes the rows that are no whole number of 16-byte
// runs (the tensor copies need them) and those of few steps (whose run the
// ring's set-up would outlast), and every scan of a -DSCAN_V1 build (the
// kernel before the ring, with the reverse mode added; chip_smoke.py times
// the two in turns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

#ifdef SCAN_V1
constexpr bool kV1 = true;
#else
constexpr bool kV1 = false;
#endif

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
// the ring kernel: at most kRingMaxTile channels a CTA (two a consumer
// thread, and a producer warp), kRingMaxStages slots of 8, 16 or
// kRingMaxSteps steps
constexpr int kRingMaxTile = 256;
constexpr int kRingMaxThreads = kRingMaxTile / 2 + 32;
constexpr int kRingMaxStages = 8;
constexpr int kRingMaxSteps = 32;
constexpr int kSmemLimit = 232448;

// loads and stores of VEC adjacent channels, converted to and from f32
template <typename T, int VEC> struct Io;

template <> struct Io<float, 1> {
  __device__ static void load(const float* p, float* out) { out[0] = __ldg(p); }
  __device__ static void store(float* p, const float* in) { *p = in[0]; }
};

template <> struct Io<float, 2> {
  __device__ static void load(const float* p, float* out) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
  // the two values as loaded from shared memory, unpacked later
  using Raw = float2;
  __device__ static Raw fetch(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static Raw zero() { return make_float2(0.f, 0.f); }
  __device__ static void unpack(const Raw& v, float* out) {
    out[0] = v.x;
    out[1] = v.y;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
};

template <> struct Io<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *p = __float2bfloat16_rn(in[0]);
  }
};

template <> struct Io<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
  using Raw = __nv_bfloat162;
  __device__ static Raw fetch(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ static Raw zero() { return __floats2bfloat162_rn(0.f, 0.f); }
  __device__ static void unpack(const Raw& v, float* out) {
    const float2 f = __bfloat1622float2(v);
    out[0] = f.x;
    out[1] = f.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(in[0], in[1]);
  }
};

// one step of the chain: a rounded multiply, then a rounded add
template <int VEC>
__device__ __forceinline__ void step(float (&carry)[VEC], const float* fa, const float* fb) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) carry[v] = __fadd_rn(__fmul_rn(fa[v], carry[v]), fb[v]);
}

template <typename T, int VEC, bool REV>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ y,
            int lead, int t_len, int c) {
  using IO = Io<T, VEC>;
  const int groups = c / VEC;  // channel groups of one lead row
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= static_cast<long long>(lead) * groups) return;
  const int row = static_cast<int>(gid / groups);
  const int c0 = static_cast<int>(gid % groups) * VEC;
  const size_t stride = static_cast<size_t>(c);
  const size_t base = static_cast<size_t>(row) * t_len * stride + c0;
  const T* pa = a + base;
  const T* pb = b + base;
  T* py = y + base;

  float carry[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) carry[v] = 0.f;

  if constexpr (!REV) {
    int t = 0;
    for (; t + kUnroll <= t_len; t += kUnroll) {
      float fa[kUnroll][VEC], fb[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        IO::load(pa + (t + u) * stride, fa[u]);
        IO::load(pb + (t + u) * stride, fb[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        step(carry, fa[u], fb[u]);
        IO::store(py + (t + u) * stride, carry);
      }
    }
    for (; t < t_len; ++t) {
      float fa[VEC], fb[VEC];
      IO::load(pa + t * stride, fa);
      IO::load(pb + t * stride, fb);
      step(carry, fa, fb);
      IO::store(py + t * stride, carry);
    }
  } else {
    // step t takes b_t and the decay a_{t+1}, 0 at t = T - 1
    int t = t_len - 1;
    for (; t + 1 >= kUnroll; t -= kUnroll) {
      float fa[kUnroll][VEC], fb[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = t - u;
        if (s + 1 < t_len) {
          IO::load(pa + (s + 1) * stride, fa[u]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) fa[u][v] = 0.f;
        }
        IO::load(pb + s * stride, fb[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        step(carry, fa[u], fb[u]);
        IO::store(py + (t - u) * stride, carry);
      }
    }
    for (; t >= 0; --t) {
      float fa[VEC], fb[VEC];
      if (t + 1 < t_len) {
        IO::load(pa + (t + 1) * stride, fa);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) fa[v] = 0.f;
      }
      IO::load(pb + t * stride, fb);
      step(carry, fa, fb);
      IO::store(py + t * stride, carry);
    }
  }
}

// the box of `map` at (lead row `row`, step t0, channel c0) into shared
// address `dst`, completing a transaction of mbarrier `bar`; its parts past
// T or C are zero-filled
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int c0, int t0,
                                         int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(t0), "r"(row), "r"(bar)
      : "memory");
}

// The ring kernel (see the header).  Grid (C / tile rounded up, lead);
// tile / 2 consumer threads, then the producer warp.  STEPS steps a stage.
template <typename T, bool REV, int STEPS>
__global__ void __launch_bounds__(kRingMaxThreads)
scan_ring_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                 T* __restrict__ y, int t_len, int c, int tile, int stages) {
  using IO = Io<T, 2>;
  using Raw = typename IO::Raw;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kRingMaxStages], empty[kRingMaxStages];
  const int consumers = blockDim.x - 32;
  const int c0 = blockIdx.x * tile;
  const int width = min(tile, c - c0);  // this tile's channels
  const unsigned pitch = static_cast<unsigned>(tile) * sizeof(T);  // a slot row
  const unsigned box = STEPS * pitch;  // one operand's box: a stage's steps
  const size_t base = static_cast<size_t>(blockIdx.y) * t_len * c + c0;
  const int nst = (t_len + STEPS - 1) / STEPS;
  // the ring, 128-byte aligned for the tensor copies: stage s is [a | b]
  const unsigned pad = (128 - (sm90::smem_addr(smem) & 127)) & 127;
  const unsigned char* ring = smem + pad;
  const unsigned ring0 = sm90::smem_addr(ring);
  const unsigned full0 = sm90::smem_addr(full);
  const unsigned empty0 = sm90::smem_addr(empty);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, consumers / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // stage k's steps [lo, lo + n): from the start, or (REV) from the end
  auto span = [&](int k, int& lo, int& n) {
    if (REV) {
      const int hi = t_len - k * STEPS;
      lo = max(0, hi - STEPS);
      n = hi - lo;
    } else {
      lo = k * STEPS;
      n = min(STEPS, t_len - lo);
    }
  };

  if (threadIdx.x >= consumers) {
    // the producer: one box of a and one of b a stage (REV: the decays
    // a_{t+1} of its steps, the row after each)
    if (threadIdx.x == consumers) {
      for (int k = 0; k < nst; ++k) {
        const int s = k % stages;
        if (k >= stages) sm90::mbar_wait(empty0 + 8 * s, (k / stages - 1) & 1);
        int lo, n;
        span(k, lo, n);
        const unsigned bar = full0 + 8 * s;
        const unsigned sa = ring0 + 2 * s * box;
        sm90::mbar_expect_tx(bar, 2 * box);
        tma_load(sa, &tma, c0, REV ? lo + 1 : lo, blockIdx.y, bar);
        tma_load(sa + box, &tmb, c0, lo, blockIdx.y, bar);
      }
    }
    return;
  }

  // the consumers: each stage's steps read into registers, the slot
  // released, then the chain
  const int ch = 2 * threadIdx.x;  // this thread's channels in the tile
  const bool own = ch < width;
  T* py = y + base + ch;
  float carry[2] = {0.f, 0.f};
  for (int k = 0; k < nst; ++k) {
    const int s = k % stages;
    int lo, n;
    span(k, lo, n);
    sm90::mbar_wait(full0 + 8 * s, (k / stages) & 1);
    const T* sa = reinterpret_cast<const T*>(ring + 2 * s * box) + ch;
    const T* sb = sa + STEPS * tile;
    Raw ra[STEPS], rb[STEPS];
    if (own) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        if (j < n) {
          // REV: the last step's decay is exactly 0
          ra[j] = REV && lo + j + 1 >= t_len ? IO::zero() : IO::fetch(sa + j * tile);
          rb[j] = IO::fetch(sb + j * tile);
        }
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(empty0 + 8 * s);
    if (own) {
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int j = REV ? STEPS - 1 - i : i;
        if (j < n) {
          float fa[2], fb[2];
          IO::unpack(ra[j], fa);
          IO::unpack(rb[j], fb);
          step(carry, fa, fb);
          IO::store(py + static_cast<size_t>(lo + j) * c, carry);
        }
      }
    }
  }
}

// The TMA map of a (lead, t, c) operand in boxes of tile channels x steps
// steps of one lead row, unswizzled, zeros past its edges
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int lead, int t_len, int c, int tile,
                int steps) {
  const sm90::Encode encode = sm90::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(lead)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * sizeof(T),
                                 static_cast<cuuint64_t>(t_len) * c * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(tile), static_cast<cuuint32_t>(steps), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int VEC, bool REV>
int launch_thread(const void* a, const void* b, void* y, int lead, int t_len, int c,
                  cudaStream_t st) {
  const long long threads = static_cast<long long>(lead) * (c / VEC);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  scan_kernel<T, VEC, REV><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      lead, t_len, c);
  return static_cast<int>(cudaGetLastError());
}

// The ring kernel at the plan's (tile, steps, stages), refused with
// cudaErrorInvalidValue unless the rows are whole 16-byte runs, the tile a
// multiple of 64 channels up to kRingMaxTile, steps one of 8, 16, 32, the
// ring fits and the operands' TMA maps encode.
template <typename T, bool REV, int STEPS = 8>
int launch_ring(const void* a, const void* b, void* y, int lead, int t_len, int c,
                int tile, int steps, int stages, cudaStream_t st) {
  if constexpr (STEPS < kRingMaxSteps) {
    if (steps != STEPS)
      return launch_ring<T, REV, 2 * STEPS>(a, b, y, lead, t_len, c, tile, steps, stages, st);
  }
  // the ring, and 128 bytes to align it
  const long long smem =
      2LL * stages * STEPS * tile * static_cast<long long>(sizeof(T)) + 128;
  CUtensorMap tma, tmb;
  if (steps != STEPS || (c * sizeof(T)) % 16 || tile % 64 || tile > kRingMaxTile ||
      stages < 2 || stages > kRingMaxStages || smem > kSmemLimit || lead > 65535 ||
      !tensor_map<T>(&tma, a, lead, t_len, c, tile, STEPS) ||
      !tensor_map<T>(&tmb, b, lead, t_len, c, tile, STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scan_ring_kernel<T, REV, STEPS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused attribute stays the last error
      return static_cast<int>(err);
    }
  }
  kernel<<<dim3((c + tile - 1) / tile, lead), tile / 2 + 32, static_cast<size_t>(smem), st>>>(
      tma, tmb, static_cast<T*>(y), t_len, c, tile, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool REV>
int dispatch(const void* a, const void* b, void* y, int lead, int t_len, int c, int tile,
             int steps, int stages, cudaStream_t st) {
  if (tile > 0 && !kV1)
    return launch_ring<T, REV>(a, b, y, lead, t_len, c, tile, steps, stages, st);
  if (c % 2 == 0) return launch_thread<T, 2, REV>(a, b, y, lead, t_len, c, st);
  return launch_thread<T, 1, REV>(a, b, y, lead, t_len, c, st);
}

template <typename T>
int dispatch(const void* a, const void* b, void* y, int lead, int t_len, int c, int reverse,
             int tile, int steps, int stages, cudaStream_t st) {
  if (reverse) return dispatch<T, true>(a, b, y, lead, t_len, c, tile, steps, stages, st);
  return dispatch<T, false>(a, b, y, lead, t_len, c, tile, steps, stages, st);
}

}  // namespace

// a, b, y (lead, t, c), contiguous and 16-byte aligned; lead, t, c >= 1.
// dtype: 0 = float32, 1 = bfloat16.  reverse: 0 the scan, 1 its reverse.
// tile, steps, stages: the launch plan's (kernels.scan.scan_plan); tile > 0
// takes the ring kernel (refused unless it takes them), 0 the thread
// kernel, as does every scan of a -DSCAN_V1 build.  Returns
// cudaGetLastError().
extern "C" int linear_scan(const void* a, const void* b, void* y, int lead, int t, int c,
                           int dtype, int reverse, int tile, int steps, int stages,
                           void* stream) {
  if (lead < 1 || t < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, b, y, lead, t, c, reverse, tile, steps, stages, st);
  return dispatch<float>(a, b, y, lead, t, c, reverse, tile, steps, stages, st);
}
