// Quantized serving kernels for sm_90a: the int8 and int4 weight-only
// dequant-matmuls, the batched int8 dequant-matmul of an MoE expert bank, and
// masked attention over an int8 KV cache.
//
// Replaces, in minidiff_tpu/kernels/quant.py:
//   dq_mm     <- _dq_mm_kernel (:58, pallas_call at :70)
//   dq_bmm    <- _dq_bmm_kernel (:274, pallas_call at :286)
//   dq4_mm    <- _dq4_mm_kernel (:412, pallas_call at :453)
//   sdpa_int8 <- _make_sdpa_int8_kernel (:138, pallas_call at :196)
// with the same arithmetic (kernels/quant.py in the port states it):
//   dq_mm:     out = (sum_k x[k] * q[k, n]) * s[n], summed in f32, cast once;
//   dq_bmm:    dq_mm for each expert e: x[e] (C, K), q[e] (K, N), s[e] (N,);
//   dq4_mm:    out = sum_k x[k] * w[k, n], w = (code * group scale) in f32
//              rounded to x's dtype before the product, summed in f32;
//   sdpa_int8: scores (q . k8) * (ks * scale) in f32, masked to
//              l <= pos + row % c (-1e30), f32 softmax, (p * vs) rounded to
//              q's dtype, then summed against v8 in f32.
// Products of a bf16 (or f32-held integer) value and an int8 code are exact
// in f32, so the sums differ from the plain versions only in their order.
//
// dq_mm, dq_bmm and dq4_mm in bf16 run on tensor cores (the tc namespace
// below; dq_mm's 2-D product is dq_bmm's tile with one expert, under its
// own kernel name).
// What bounds them on the H100: at decode (<= 16 activation rows) a
// dequant-matmul does 2 flop per row per weight byte (4 for int4), far under
// the ~295 flop/byte ridge, so it is bound by the weight's bytes, which it
// must read once, and by the latency of those loads; at a 128-row prefill it
// does ~256 flop per byte, at the ridge, bound by the tensor cores.  The
// SIMT tile they replace (dq_mm_tile, below) did each product with FFMAs on
// 8 rows per CTA, so a 128-row bank was streamed 16 times, at 200-255
// registers and one CTA per SM, with plain 16-byte loads and no stages in
// flight.  The design:
//   - copies: a ring of 4 shared-memory stages filled by cp.async (16-byte
//     .cg copies; 8-byte .ca where a weight row is no whole number of 16
//     bytes), each holding the stored weight tile, the x tile it meets and,
//     for int4, one scale row per plane; rows past the split, rows past m and
//     columns past n are zero-filled by the copy itself.  Each thread's
//     copies are the same every stage, their addresses computed once;
//   - dequantization in registers: ldmatrix.trans of the stored [k][n] byte
//     tile hands each lane the bytes of two adjacent columns at a k pair,
//     which become the MMA's weight fragment (even columns on rows 0-7 of the
//     16-row side, odd columns on rows 8-15).  A byte becomes its code
//     exactly by a byte permute into the mantissa of 2^23 and one
//     subtraction; int8 codes stay unscaled (the column scale multiplies the
//     f32 sum in the epilogue, as _dq_bmm_kernel does), int4 codes are
//     multiplied by their group's scale in f32 and rounded to bf16 before the
//     product, as _dq4_mm_kernel does.  A stage lies inside one scale group of
//     each int4 plane (group % stage rows == 0, K/2 % group == 0), so its
//     scale rows are loaded once per stage, and one packed tile feeds two
//     products: plane 0 against x's columns [k0, k0 + T), plane 1 against
//     [K/2 + k0, K/2 + k0 + T);
//   - orientation: both tiles compute out^T = W^T x^T, the weight's columns
//     on the MMA's M side.  <= 16 rows ("small"): mma.sync m16n8k16, the
//     rows on its 8-wide side (no lane spent on padding rows), 64 columns
//     per CTA, two warps per 32 columns each taking half the k16 slices;
//     9-16 rows take both 8-row blocks in one CTA ("small16"), which reads
//     each weight byte once where two 8-row CTAs read it twice (at 16 rows
//     in chip_smoke.py's dq_tile_ab, 1.1-2x faster than "small8" and
//     1.7-3.3x faster than the large tile);
//     17..256 rows ("large"): wgmma m64n128k16 with A, the weight, from
//     registers (each warp converts only its own 16 columns, so no byte is
//     converted twice) and B, x, from shared memory through a matrix
//     descriptor (x staged in 8-row x 16-byte core matrices); warpgroups of
//     64 columns by the CTA's 128 rows (int8 four, 256 columns and one CTA
//     per SM, so that each expert's x is read from L2 by half as many CTAs;
//     int4 two), one stage's MMAs in flight while the next stages are
//     copied.  What bounds this tile is open (PERF.md, §6): it runs well
//     under the MMA rate, yet TMA copies (x multicast to column-tile pairs)
//     made it no faster;
//   - split-K where the output tiles are too few for the card (the decode
//     banks' w2, int4's narrow fc2, the 128-row int4 products and the w2
//     bank at 128 rows; the counts are dq_plan's, measured per tile by
//     chip_smoke.py's dq_split_ab): the splits of a tile are one
//     thread-block cluster (up to 16 CTAs, the H100's non-portable size).
//     Each CTA stores its f32 partial into the owners' shared memory
//     (st.shared::cluster: slice r of the tile to CTA r), and each owner
//     sums its S rows in rank order, scales and casts: deterministic, no
//     atomics, no workspace and no second launch.  Split s takes units
//     [s * units / S, (s + 1) * units / S) of the stored weight rows, a
//     unit one stage (int8) or one scale group (int4).
// The launch plan (tile, splits) is decided in Python before
// launch (kernels/quant.py dq_plan) from shapes and dtypes; f32, and shapes
// outside the tiles' rule (K % 16, n % 8, an int4 group the stages do not
// divide), take the SIMT tile.  Built with -DDQ_SIMT_BF16, every dq_mm,
// dq_bmm and dq4_mm runs on the SIMT tile (chip_smoke.py's A/B of the two).
//
// The SIMT tile (f32, and bf16 outside the tiles' rule): each CTA owns a
// 64-column tile of the output and 8 activation rows; its 8 warps split K,
// each lane streams 16 consecutive columns of one weight row with one
// 16-byte load and keeps 8 x 16 f32 accumulators in registers, while the x
// rows are staged in shared memory in chunks of K.  Lanes of one warp sum by
// shuffle, the 8 warps through shared memory, and the epilogue scales and
// casts.  More than 8 rows (a prefill of up to 256) tile over blockIdx.y and
// re-read the weight from L2.  f32 inputs use FFMA (no TF32).  int4: the
// high nibble is an arithmetic shift of the sign-extended byte, the low one
// (b << 28) >> 28; row r belongs to group r / group, so the low plane reads
// groups [0, G/2) and the high plane [G/2, G).  A weight row that is no whole
// number of 16-byte vectors (N % 16 != 0) is read byte by byte.  dq_bmm runs
// dq_mm's tile with the expert as a third grid axis.
//
// sdpa_int8 at decode reads the int8 cache lines and their f32 scales once:
// (hd + 4) bytes per key for K and for V, bound by bytes.  Keys past the
// last visible one (pos + c - 1) are never read, since their probabilities
// are exactly 0.  One CTA per (batch row, kv head), the first kernel
// (kept below for -DDECODE_ATTN_ONE_CTA, chip_smoke.py's
// decode_attn_route_ab), left the card idle (32 CTAs at 4 rows x 8 heads),
// and it kept every f32 score of its (row, head) in shared memory, so that
// it refused L above 13,376 at g 4.  The design (namespace dattn):
//   - split L: the S CTAs of one thread-block cluster (grid (S, kv, B),
//     S = 1..16 by kernels/quant.py sdpa_int8_plan, from shapes only: one
//     wave of the card, and never fewer than its scores' shared memory
//     needs) share one (row, kv head); split s takes the keys of [0, l_end)
//     on 16-key boundaries, units [s U / S, (s + 1) U / S) of the U
//     16-key units, and holds its scores only;
//   - the ring: each split's K lines, then its V lines, stream through 4
//     stages of 16 KB copied by the TMA (cp.async.bulk, one mbarrier per
//     stage); V's first stages copy while the cluster exchanges;
//   - the JAX arithmetic, which rounds the normalised p * vs, so no split
//     rounds before the global max and sum are known: phase 1 scores its
//     keys, hd / 16 lanes per key (16 codes each, made exact in f32 by a
//     byte permute, the query rows in registers), and takes each row's max;
//     a cluster exchange (st.shared::cluster into every peer, then the
//     cluster barrier) gives the global max, a second the global sum, each
//     reduced in rank order; phase 3 rounds p * vs of its keys and sums
//     them against v8 (4 codes per thread, 4 keys per step), the key groups
//     summed through the freed ring, and the S partials are summed in rank
//     order through distributed shared memory (slice r of the rows to CTA
//     r), as dq_bmm's split-K does.  The result is the one-CTA kernel's up
//     to the order of f32 sums, and the same bits on every run.
// Head dims 64, 128 and 256 are instantiated (the JAX kernel takes any
// multiple of 128), each with query rows in blocks of 1, 2, 4 or 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int BN = 64;                  // output columns per CTA
constexpr int CG = BN / 16;             // 16-column groups per weight row
constexpr int KR = 32 / CG;             // weight rows per warp step
constexpr int KSTEP = KR * kWarps;      // weight rows per CTA step
constexpr int MT = 8;                   // activation rows per CTA
constexpr int KC = 512;                 // x columns staged per chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// a value rounded to T, kept in f32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16 signed bytes of a weight row from column c0, zeros past n.
template <bool VEC>
__device__ __forceinline__ void load16(const int8_t* row, int c0, int n, int8_t* b) {
  if (VEC) {
    int4 v = make_int4(0, 0, 0, 0);
    if (c0 < n) v = __ldg(reinterpret_cast<const int4*>(row + c0));
    const int8_t* p = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = p[j];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = (c0 + j < n) ? row[c0 + j] : 0;
  }
}

// Sum acc over the KR lanes of a warp that hold the same columns, put the
// warp's sums in red[warp], then reduce the warps and write the tile through
// epilogue(row, col, sum).
template <typename F>
__device__ __forceinline__ void reduce_tile(float (&acc)[MT][16],
                                            float (*red)[MT][BN], int row0,
                                            int col_base, int m, int n, F epilogue) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % CG, kr = lane / CG;
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = CG; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
      acc[r][j] = v;
    }
  if (kr == 0) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][r][cg * 16 + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int row = row0 + r, col = col_base + c;
    if (row < m && col < n) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][c];
      epilogue(row, col, sum);
    }
  }
}

// Stage x[row0:row0+MT, k0:k0+len) as f32 into dst[r * ld + c], zeros past
// m and len.
template <typename T>
__device__ __forceinline__ void stage_x(float* dst, int ld, const T* x, int row0,
                                        int m, int k, int k0, int len) {
  for (int i = threadIdx.x; i < MT * ld; i += kThreads) {
    const int r = i / ld, c = i % ld;
    float v = 0.f;
    if (row0 + r < m && c < len) v = to_f(x[static_cast<size_t>(row0 + r) * k + k0 + c]);
    dst[i] = v;
  }
}

// One CTA's (8 rows, 64 columns) tile of (x @ q) * s.
template <typename T, bool VEC>
__device__ __forceinline__ void dq_mm_tile(const T* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ s,
                                           T* __restrict__ out, int m, int n, int k) {
  __shared__ float xs[MT * KC];
  __shared__ float red[kWarps][MT][BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % CG, kr = lane / CG;
  const int col_base = blockIdx.x * BN, c0 = col_base + cg * 16;
  const int row0 = blockIdx.y * MT;
  float acc[MT][16];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    const int len = min(KC, k - k0);
    __syncthreads();
    stage_x(xs, KC, x, row0, m, k, k0, len);
    __syncthreads();
#pragma unroll 4
    for (int kk = warp * KR + kr; kk < len; kk += KSTEP) {
      int8_t b[16];
      load16<VEC>(q + static_cast<size_t>(k0 + kk) * n, c0, n, b);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float xv = xs[r * KC + kk];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(xv, static_cast<float>(b[j]), acc[r][j]);
      }
    }
  }
  reduce_tile(acc, red, row0, col_base, m, n, [&](int row, int col, float sum) {
    out[static_cast<size_t>(row) * n + col] = from_f<T>(sum * s[col]);
  });
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dq_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ s, T* __restrict__ out, int m, int n, int k) {
  dq_mm_tile<T, VEC>(x, q, s, out, m, n, k);
}

// blockIdx.z is the expert: its operands start one expert's stride further on
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dq_bmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, T* __restrict__ out, int c, int n, int k) {
  const size_t e = blockIdx.z;
  dq_mm_tile<T, VEC>(x + e * c * k, q + e * k * n, s + e * n, out + e * c * n, c, n, k);
}

constexpr int KC4 = 256;  // packed rows of x staged per chunk (both planes)

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dq4_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ p,
              const float* __restrict__ s, T* __restrict__ out, int m, int n,
              int k, int group) {
  __shared__ float xs[2][MT * KC4];  // [0]: low-plane rows, [1]: high-plane rows
  __shared__ float red[kWarps][MT][BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % CG, kr = lane / CG;
  const int col_base = blockIdx.x * BN, c0 = col_base + cg * 16;
  const int row0 = blockIdx.y * MT;
  const int kh = k / 2;
  float acc[MT][16];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < kh; k0 += KC4) {
    const int len = min(KC4, kh - k0);
    __syncthreads();
    stage_x(xs[0], KC4, x, row0, m, k, k0, len);
    stage_x(xs[1], KC4, x, row0, m, k, kh + k0, len);
    __syncthreads();
    // one weight row at a time: two in flight took all 255 registers and
    // spilled
#pragma unroll 1
    for (int kk = warp * KR + kr; kk < len; kk += KSTEP) {
      int8_t b[16];
      load16<VEC>(p + static_cast<size_t>(k0 + kk) * n, c0, n, b);
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        const float* srow = s + static_cast<size_t>((plane * kh + k0 + kk) / group) * n;
        float w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v = static_cast<int>(b[j]);  // sign-extended byte
          const int code = plane ? (v >> 4)
                                 : static_cast<int>(static_cast<unsigned>(v) << 28) >> 28;
          const float sc = (c0 + j < n) ? __ldg(srow + c0 + j) : 0.f;
          w[j] = round_to<T>(static_cast<float>(code) * sc);
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xs[plane][r * KC4 + kk];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
        }
      }
    }
  }
  reduce_tile(acc, red, row0, col_base, m, n, [&](int row, int col, float sum) {
    out[static_cast<size_t>(row) * n + col] = from_f<T>(sum);
  });
}

template <typename T>
int launch_dq(bool int4, const void* x, const void* w, const void* s, void* out,
              int experts, int m, int n, int k, int group, cudaStream_t st) {
  // experts: the bank's expert count for dq_bmm, 0 for the 2-D products
  const dim3 grid((n + BN - 1) / BN, (m + MT - 1) / MT, experts > 0 ? experts : 1);
  const bool vec = n % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  T* op = static_cast<T*>(out);
  if (int4) {
    if (vec) dq4_mm_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, n, k, group);
    else dq4_mm_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, n, k, group);
  } else if (experts > 0) {
    if (vec) dq_bmm_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, n, k);
    else dq_bmm_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, n, k);
  } else {
    if (vec) dq_mm_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, n, k);
    else dq_mm_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dq_bmm and dq4_mm in bf16: the tensor-core tiles
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

// 8 bytes from global memory into shared memory (a weight row of no whole
// number of 16 bytes); src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

struct Args {
  const bf16* x;      // (E, m, k) activations
  const int8_t* w;    // (E, k, n) int8 codes, or (k/2, n) packed int4
  const float* s;     // (E, n) column scales, or (k/group, n) group scales
  bf16* out;          // (E, m, n)
  int m, n, k, group;
  int splits;         // K splits: the CTAs of one cluster
};

// The tile of each launch plan (kernels/quant.py ``TILES`` and ``dq_plan``).
// MODE 0 / 1 ("small8" / "small16", <= 8 / <= 16 activation rows):
// out^T = W^T x^T on mma.sync, 16 output columns on the MMA's 16-row side
// and the rows on its 8-wide side; 64 columns per CTA, 4 warps: two of 32
// columns for each half of a stage's k16 slices.  MODE 2 ("large", 17..256
// rows): out^T = W^T x^T on wgmma, warpgroups of 64 output columns by
// the CTA's 128 activation rows; int8 four of them (256 columns, one CTA
// per SM, so that x is read from L2 half as often), int4 two.  P is the
// number of weight planes a stored row feeds: 1 (int8), 2 (int4: packed
// row i holds K rows i and K/2 + i).
template <int P, int MODE>
struct Tile {
  static constexpr bool kSmall = MODE < 2;
  static constexpr int NB = MODE == 1 ? 2 : 1;       // 8-row blocks (small)
  static constexpr int kThreads = kSmall ? 128 : P == 1 ? 512 : 256;
  static constexpr int kMinBlocks = kSmall ? 4 : P == 1 ? 1 : 2;
  static constexpr int XR = kSmall ? 8 * NB : 128;   // activation rows per CTA
  static constexpr int BN = kSmall ? 64 : P == 1 ? 256 : 128;  // output columns per CTA
  static constexpr int RB = P == 2 ? 32 : 64;        // stored rows per stage
  // the cp.async ring, and the stages in flight: the large tile keeps one
  // more slot for the stage its MMAs may still read
  static constexpr int kSlots = !kSmall && P == 1 ? 5 : 4;
  static constexpr int kAhead = kSmall ? kSlots - 1 : kSlots - 2;
  static constexpr int RLD = BN + 16;                // stored row stride (bytes): conflict-free
  static constexpr int XLD = P * RB + 8;             // small: x row stride (bf16), conflict-free
  static constexpr int kRaw = RB * RLD;
  static constexpr int kX = kSmall ? XR * XLD * 2 : XR * P * RB * 2;  // large: core matrices
  static constexpr int kSc = P == 2 ? 2 * BN * 4 : 0;
  static constexpr int kSlot = kRaw + kX + kSc;
  // the sums: small, the k-groups' tiles and the cluster's receive buffer;
  // large, the receive buffer
  static constexpr int kRed = (kSmall ? 3 : 1) * XR * BN * 4;
  static constexpr int kBody = kSlots * kSlot > kRed ? kSlots * kSlot : kRed;
  static constexpr int kSmem = kBody + BN * 4;  // then the int8 column scales
  static constexpr int kWChunks = RB * BN / 16 / kThreads;  // 16-byte weight copies a thread
  static_assert(kRaw % 128 == 0 && kX % 128 == 0 && kSlot % 128 == 0, "aligned slots");
  static_assert(RB * BN % (16 * kThreads) == 0, "whole weight copies per thread");
};

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.  Not
// volatile: a pure function of its registers, which the compiler may
// schedule among the loads and conversions.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte J of u placed in the low mantissa of 2^23, minus bias: u's bytes
// hold code + bias - 2^23 (unsigned), so the result is the code, exactly.
template <int J>
__device__ __forceinline__ float byte_code(unsigned u, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | J)), bias);
}

// two f32 values that bf16 holds exactly, as bf16x2 (lo in the low half):
// their upper halves
__device__ __forceinline__ unsigned pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The weight operand from one register of an ldmatrix.trans of the stored
// [k][n] byte tile (b16 = two adjacent columns): its bytes are (k0, 2j),
// (k0, 2j + 1), (k1, 2j), (k1, 2j + 1) for k1 = k0 + 1.  `even` packs the
// k pair of column 2j, `odd` that of column 2j + 1, each as bf16x2 (k0 low):
// the fragment of an MMA whose weight columns are the even (or odd) columns
// of the tile.
struct Pair {
  unsigned even, odd;
};

// int8: the codes, exact in bf16 (the column scale multiplies the f32 sum)
__device__ __forceinline__ Pair int8_pair(unsigned w) {
  const unsigned u = w ^ 0x80808080u;  // code + 128 in each byte
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  return {pack_exact(byte_code<0>(u, kBias), byte_code<2>(u, kBias)),
          pack_exact(byte_code<1>(u, kBias), byte_code<3>(u, kBias))};
}

// int4, one plane (HI: the high nibbles, the rows K/2 + i): each code times
// its column's group scale in f32, rounded to bf16, as the plain version
template <bool HI>
__device__ __forceinline__ Pair int4_pair(unsigned w, float2 s) {
  const unsigned u = ((HI ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;  // code + 8
  constexpr float kBias = 8388616.f;                                     // 2^23 + 8
  return {pack_bf16(__fmul_rn(byte_code<0>(u, kBias), s.x),
                    __fmul_rn(byte_code<2>(u, kBias), s.x)),
          pack_bf16(__fmul_rn(byte_code<1>(u, kBias), s.y),
                    __fmul_rn(byte_code<3>(u, kBias), s.y))};
}

template <int P, int PLANE>
__device__ __forceinline__ Pair weight_pair(unsigned w, float2 s) {
  if constexpr (P == 1) return int8_pair(w);
  else return int4_pair<PLANE == 1>(w, s);
}

// The cluster's split-K reduction, through distributed shared memory.  The
// S CTAs of a cluster hold the f32 partials of one output tile of T
// elements; CTA r owns the tile's slice [r T/S, (r+1) T/S).  Each CTA
// stores every slice of its partial into the slice owner's shared memory,
// at row `rank` of the owner's receive buffer [S][T/S] (remote stores need
// no round trip), and after the cluster barrier each owner sums its S rows
// in rank order: deterministic, no atomics.
// (sm90::cluster_rank and cluster_barrier, wgmma.cuh)
// elements i.. (4 or 2) of this CTA's partial into its owner's receive
// buffer at shared-memory offset `recv` (the same in every CTA of the
// cluster); a slice is 2^lslice elements
__device__ __forceinline__ unsigned owner_addr(unsigned recv, int i, int lslice, unsigned rank) {
  const int owner = i >> lslice, slice = 1 << lslice;
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(recv + ((static_cast<int>(rank) - owner) * slice + i) * 4), "r"(owner));
  return addr;
}
__device__ __forceinline__ void push4(unsigned recv, int i, int lslice, unsigned rank,
                                      float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   owner_addr(recv, i, lslice, rank)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void push2(unsigned recv, int i, int lslice, unsigned rank,
                                      float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(
                   owner_addr(recv, i, lslice, rank)),
               "f"(v.x), "f"(v.y)
               : "memory");
}
// after the barrier: this CTA's slice, summed over the S rows in order,
// to put(element index, float4)
template <typename F>
__device__ __forceinline__ void sum_slice(const float* recv, int T, int S, unsigned rank,
                                          int threads, F put) {
  const int slice = T / S;
  for (int k = 4 * static_cast<int>(threadIdx.x); k < slice; k += 4 * threads) {
    float4 v = *reinterpret_cast<const float4*>(recv + k);
    for (int j = 1; j < S; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(recv + j * slice + k);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    put(static_cast<int>(rank) * slice + k, v);
  }
}

// The large tile's tools.  out^T = W^T x^T as warpgroup MMAs: each
// warpgroup owns 64 output columns (the MMA's M side), the CTA's 128
// activation rows are its N side.  A, the dequantized weight, comes from
// registers: each warp turns its own 16 columns' bytes into bf16 fragments
// (no two warps convert the same byte).  B, x, is read by the tensor cores
// from shared memory through a matrix descriptor (x staged in 8-row x
// 16-byte core matrices).  One stage's MMAs run while the warps wait for,
// and copy, the next stages.

template <int P, int MODE>
__device__ __forceinline__ void tc_body(const Args& a, bool vec16) {
  using L = Tile<P, MODE>;
  extern __shared__ __align__(128) unsigned char dq_smem[];
  const unsigned sbase = smem_addr(dq_smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4;

  const int e = blockIdx.z;
  const int split = blockIdx.x % a.splits;
  const int col0 = blockIdx.x / a.splits * L::BN, row0 = blockIdx.y * L::XR;
  const int kh = a.k / 2, stored = P == 2 ? kh : a.k;
  // split s takes the stored rows of units [s * units / S, (s + 1) * units / S),
  // a unit one stage (int8) or one scale group (int4: so that every split
  // starts on a group boundary of both planes)
  const int unit = P == 2 ? a.group : L::RB;
  const int units = (stored + unit - 1) / unit;
  const int rbeg = split * units / a.splits * unit;
  const int rend = min(stored, (split + 1) * units / a.splits * unit);
  const int iters = (rend - rbeg + L::RB - 1) / L::RB;
  const bf16* x = a.x + static_cast<size_t>(e) * a.m * a.k;
  const int8_t* w = a.w + static_cast<size_t>(e) * stored * a.n;
  const float* s = a.s + static_cast<size_t>(e) * a.n;

  // Each thread's copies are the same every stage, one stage's rows on:
  // their addresses are computed once.  Weight: 16-byte chunks (8-byte
  // when n % 16 != 0) of the RB x BN tile; x: 16-byte chunks of the XR x
  // (P * RB) tile, plane p's columns from p * K/2 (small: rows of XLD; large:
  // 8-row x 16-byte core matrices, KC along K, for the wgmma descriptor).
  const int wcpr = vec16 ? L::BN / 16 : L::BN / 8;   // chunks per weight row
  const int wbytes = vec16 ? 16 : 8;
  const int wr0 = tid / wcpr, wc = (tid % wcpr) * wbytes, wrstep = L::kThreads / wcpr;
  const bool wcol_ok = col0 + wc < a.n;
  const int8_t* wsrc = w + static_cast<size_t>(rbeg + wr0) * a.n + col0 + wc;
  const size_t wstep = static_cast<size_t>(wrstep) * a.n;
  const unsigned wdst = sbase + wr0 * L::RLD + wc;
  constexpr int KC = P * L::RB / 8;                  // x chunks per row
  const int xkc = tid % KC, xplane = xkc * 8 / L::RB, xcol = xkc * 8 % L::RB;
  const int xr0 = tid / KC;
  constexpr int XRSTEP = L::kThreads / KC;
  const bf16* xsrc = x + static_cast<size_t>(row0 + xr0) * a.k + xplane * kh + rbeg + xcol;
  const unsigned xdst =
      sbase + L::kRaw
      + (L::kSmall ? (xr0 * L::XLD + xkc * 8) * 2 : ((xr0 / 8) * KC + xkc) * 128 + (xr0 % 8) * 16);
  constexpr unsigned XJ = L::kSmall ? XRSTEP * L::XLD * 2 : XRSTEP / 8 * KC * 128;

  auto load = [&](int it) {
    const unsigned slot = it % L::kSlots * L::kSlot;
    const int r0 = it * L::RB;  // from rbeg
#pragma unroll
    for (int j = 0; j < 2 * L::kWChunks; ++j) {
      if (j < L::kWChunks || !vec16) {  // twice the chunks at 8 bytes
        const bool ok = wcol_ok && rbeg + r0 + wr0 + j * wrstep < rend;
        const int8_t* src = ok ? wsrc + static_cast<size_t>(r0) * a.n + j * wstep : w;
        if (vec16) cp_async16(wdst + slot + j * wrstep * L::RLD, src, ok ? 16 : 0);
        else cp_async8(wdst + slot + j * wrstep * L::RLD, src, ok ? 8 : 0);
      }
    }
#pragma unroll
    for (int j = 0; j * XRSTEP < L::XR; ++j) {
      if (L::XR % XRSTEP == 0 || xr0 + j * XRSTEP < L::XR) {
        const bool ok = row0 + xr0 + j * XRSTEP < a.m && rbeg + r0 + xcol < rend;
        const bf16* src = ok ? xsrc + r0 + static_cast<size_t>(j * XRSTEP) * a.k : x;
        cp_async16(xdst + slot + j * XJ, src, ok ? 16 : 0);
      }
    }
    if constexpr (P == 2) {  // one scale row per plane: the stage lies in one group of each
      if (tid < L::BN / 2) {
        const int plane = tid / (L::BN / 4), c = (tid % (L::BN / 4)) * 4;
        const int grp = (plane * kh + rbeg + r0) / a.group;
        const bool ok = col0 + c < a.n;
        cp_async16(sbase + slot + L::kRaw + L::kX + (plane * L::BN + c) * 4,
                   ok ? s + static_cast<size_t>(grp) * a.n + col0 + c : s, ok ? 16 : 0);
      }
    }
  };

  float* colscale = reinterpret_cast<float*>(dq_smem + L::kBody);  // int8: s[e][col0..]
  if (P == 1 && tid < L::BN / 4) {
    const bool ok = col0 + 4 * tid < a.n;
    cp_async16(sbase + L::kBody + 16 * tid, ok ? s + col0 + 4 * tid : s, ok ? 16 : 0);
  }
#pragma unroll
  for (int it = 0; it < L::kAhead; ++it) {
    if (it < iters) load(it);
    cp_async_commit();
  }

  bf16* out = a.out + static_cast<size_t>(e) * a.m * a.n;
  // elements i..i+3 of the [XR][BN] tile, scaled (int8) and cast; n % 8 == 0
  // and i % 4 == 0: the four columns are all in or all out
  auto put = [&](int i, float4 v) {
    const int row = row0 + i / L::BN, c = i % L::BN;
    if (row >= a.m || col0 + c >= a.n) return;
    if (P == 1) {
      const float4 sv = *reinterpret_cast<const float4*>(colscale + c);
      v.x *= sv.x;
      v.y *= sv.y;
      v.z *= sv.z;
      v.w *= sv.w;
    }
    *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * a.n + col0 + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  };
  float* red = reinterpret_cast<float*>(dq_smem);
  constexpr int T = L::XR * L::BN;
  const int lslice = __ffs(T / a.splits) - 1;  // T and the splits are powers of two

  if constexpr (L::kSmall) {
    // warp (wn, kg) = (warp % 2, warp / 2) owns columns 32 wn.. and the k16
    // slices kg, kg + 2, ... of each stage
    const int wn = warp % 2, kg = warp / 2;
    float acc[2][L::NB][4] = {};  // [16-column half][8-row block]
    // ldmatrix addresses within a slot: the weight tile's k16 x 32 bytes of
    // the warp's columns (transposed), x's rows
    const unsigned wfrag =
        sbase + (lane % 8 + ((lane / 8) % 2) * 8) * L::RLD + 32 * wn + (lane / 16) * 16;
    const unsigned xfrag =
        sbase + L::kRaw
        + (((L::NB == 2 ? lane / 16 : 0) * 8 + lane % 8) * L::XLD + ((lane / 8) % 2) * 8) * 2;
    for (int it = 0; it < iters; ++it) {
      cp_async_wait<L::kAhead - 1>();
      __syncthreads();  // stage it landed; every warp is done with stage it - 1
      if (it + L::kAhead < iters) load(it + L::kAhead);
      cp_async_commit();

      const unsigned slot = it % L::kSlots * L::kSlot;
      float2 sc[2][2] = {};  // [plane][16-column half]: the scales of columns 2g, 2g + 1
      if constexpr (P == 2) {
        const float* sp =
            reinterpret_cast<const float*>(dq_smem + slot + L::kRaw + L::kX) + 32 * wn + 2 * g;
#pragma unroll
        for (int plane = 0; plane < 2; ++plane)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sc[plane][h] = *reinterpret_cast<const float2*>(sp + plane * L::BN + 16 * h);
      }
      // the weight bytes of rows kk..kk+15, the warp's 32 columns: [0] k 0-7
      // / columns 0-15, [1] k 8-15 / 0-15, [2] k 0-7 / 16-31, [3] k 8-15 /
      // 16-31; the next slice's are loaded before this one's products
      constexpr int KSTEP = 32;  // each k-group takes every other slice
      unsigned wr[4];
      ldsm_x4_t(wr, wfrag + slot + 16 * kg * L::RLD);
#pragma unroll
      for (int q = 0; q < L::RB / KSTEP; ++q) {
        const int kk = 16 * kg + q * KSTEP;
        const unsigned cur[4] = {wr[0], wr[1], wr[2], wr[3]};
        if (q + 1 < L::RB / KSTEP) ldsm_x4_t(wr, wfrag + slot + (kk + KSTEP) * L::RLD);
#pragma unroll
        for (int plane = 0; plane < P; ++plane) {
          // B = x^T of 8 rows per block
          unsigned bx[4];
          const unsigned xk = xfrag + slot + (plane * L::RB + kk) * 2;
          if constexpr (L::NB == 2) {
            ldsm_x4(bx, xk);
          } else {
            unsigned b2[2];
            ldsm_x2(b2, xk);
            bx[0] = b2[0];
            bx[1] = b2[1];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // A = W^T of 16 columns: rows 0-7 the even, 8-15 the odd ones
            Pair lo, hi;
            if (plane == 0) {
              lo = weight_pair<P, 0>(cur[2 * h], sc[0][h]);
              hi = weight_pair<P, 0>(cur[2 * h + 1], sc[0][h]);
            } else {
              lo = weight_pair<P, 1>(cur[2 * h], sc[1][h]);
              hi = weight_pair<P, 1>(cur[2 * h + 1], sc[1][h]);
            }
            const unsigned af[4] = {lo.even, lo.odd, hi.even, hi.odd};
#pragma unroll
            for (int b = 0; b < L::NB; ++b) mma(acc[h][b], af, bx[2 * b], bx[2 * b + 1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the sums

    // acc[h][b][t]: column 32 wn + 16 h + 2 g (+ 1 for t >= 2), row
    // 8 b + 2 (lane % 4) (+ 1 for odd t); the two k-groups meet in order
    const int c2 = 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          red[kg * T + (8 * b + c2 + (t & 1)) * L::BN + 32 * wn + 16 * h + 2 * g + (t >> 1)] =
              acc[h][b][t];
    __syncthreads();
    if (a.splits == 1) {
#pragma unroll
      for (int i = 4 * tid; i < T; i += 4 * L::kThreads) {
        const float4 p = *reinterpret_cast<const float4*>(red + i);
        const float4 q = *reinterpret_cast<const float4*>(red + T + i);
        put(i, make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w));
      }
    } else {
      // the receive buffer [S][T/S] sits past the k-groups' tiles, where a
      // peer still streaming its stages may hold its ring: wait for all
      const unsigned rank = cluster_rank(), recv = sbase + 2 * T * 4;
      cluster_barrier();
      for (int i = 4 * tid; i < T; i += 4 * L::kThreads) {
        const float4 p = *reinterpret_cast<const float4*>(red + i);
        const float4 q = *reinterpret_cast<const float4*>(red + T + i);
        push4(recv, i, lslice, rank, make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w));
      }
      cluster_barrier();
      sum_slice(red + 2 * T, T, a.splits, rank, L::kThreads, put);
    }
  } else {
    // warpgroup wg = warp / 4 owns output columns 64 wg..; its warp wq =
    // warp % 4 converts the weight of columns c0 = 64 wg + 16 wq .. + 15 into
    // the A fragment of rows 16 wq.. (rows 0-7 the even, 8-15 the odd ones)
    const int c0 = 64 * (warp / 4) + 16 * (warp % 4);
    // ldmatrix.x4.trans of 32 stored rows at once: four 8-row matrices
    // stacked along K, the k halves of two k16 steps
    const unsigned wfrag = sbase + lane * L::RLD + c0;
    constexpr int NS = L::RB / 16;  // k16 steps per plane and stage
    float acc[64];  // defined by the first MMA
    for (int it = 0; it < iters; ++it) {
      cp_async_wait<L::kAhead - 1>();
      __syncthreads();  // stage it landed; every warpgroup is done with stage it - 2
      if (it + L::kAhead < iters) load(it + L::kAhead);
      cp_async_commit();

      const unsigned slot = it % L::kSlots * L::kSlot;
      float2 sc[2] = {};  // [plane]: the scales of columns c0 + 2g, c0 + 2g + 1
      if constexpr (P == 2) {
        const float* sp = reinterpret_cast<const float*>(dq_smem + slot + L::kRaw + L::kX);
        sc[0] = *reinterpret_cast<const float2*>(sp + c0 + 2 * g);
        sc[1] = *reinterpret_cast<const float2*>(sp + L::BN + c0 + 2 * g);
      }
      unsigned wr[NS / 2][4];
#pragma unroll
      for (int q = 0; q < NS / 2; ++q) ldsm_x4_t(wr[q], wfrag + slot + 32 * q * L::RLD);
      wgmma_wait<0>();  // the previous stage's MMAs no longer read the A registers
      unsigned af[P * NS][4];
#pragma unroll
      for (int st = 0; st < NS; ++st)
#pragma unroll
        for (int plane = 0; plane < P; ++plane) {
          const unsigned* c = wr[st / 2] + 2 * (st % 2);
          Pair lo, hi;
          if (plane == 0) {
            lo = weight_pair<P, 0>(c[0], sc[0]);
            hi = weight_pair<P, 0>(c[1], sc[0]);
          } else {
            lo = weight_pair<P, 1>(c[0], sc[1]);
            hi = weight_pair<P, 1>(c[1], sc[1]);
          }
          unsigned* f = af[plane * NS + st];
          f[0] = lo.even;
          f[1] = lo.odd;
          f[2] = hi.even;
          f[3] = hi.odd;
        }
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < P * NS; ++f)  // x's k offset in the stage: 16 f (plane 1 from RB)
        wgmma_m64n128_rs<0>(acc, af[f], desc(sbase + slot + L::kRaw + 2 * f * 128, 128, KC * 128),
                      it > 0 || f > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    cp_async_wait<0>();

    // acc[4j + t]: output column c0 + 2g (+ 1 for t >= 2), activation row
    // 8 j + 2 (lane % 4) (+ 1 for odd t)
    const int c2 = 2 * (lane % 4), col = col0 + c0 + 2 * g;
    if (a.splits == 1) {
      if (col < a.n) {
        const float2 cs = P == 1 ? *reinterpret_cast<const float2*>(colscale + c0 + 2 * g)
                                 : make_float2(1.f, 1.f);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * j + c2 + r;
            if (row < a.m)
              *reinterpret_cast<unsigned*>(out + static_cast<size_t>(row) * a.n + col) =
                  pack_bf16(acc[4 * j + r] * cs.x, acc[4 * j + 2 + r] * cs.y);
          }
      }
    } else {
      // the receive buffer [S][T/S] overlays the ring: wait for every peer
      // to finish its stages
      const unsigned rank = cluster_rank();
      cluster_barrier();
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          push2(sbase, (8 * j + c2 + r) * L::BN + c0 + 2 * g, lslice, rank,
                make_float2(acc[4 * j + r], acc[4 * j + 2 + r]));
      cluster_barrier();
      sum_slice(red, T, a.splits, rank, L::kThreads, put);
    }
  }
}

}  // namespace tc

// The kernels under their own names, so that profiles tell them apart
// (dq_mm's 2-D product is dq_bmm's tile with one expert).  MODE 0 / 1: the
// small tile for <= 8 / <= 16 rows; 2: the large tile.
template <int MODE>
__global__ void __launch_bounds__(tc::Tile<1, MODE>::kThreads, tc::Tile<1, MODE>::kMinBlocks)
dq_bmm_tc_kernel(tc::Args a, bool vec16) {
  tc::tc_body<1, MODE>(a, vec16);
}

template <int MODE>
__global__ void __launch_bounds__(tc::Tile<1, MODE>::kThreads, tc::Tile<1, MODE>::kMinBlocks)
dq_mm_tc_kernel(tc::Args a, bool vec16) {
  tc::tc_body<1, MODE>(a, vec16);
}

template <int MODE>
__global__ void __launch_bounds__(tc::Tile<2, MODE>::kThreads, tc::Tile<2, MODE>::kMinBlocks)
dq4_mm_tc_kernel(tc::Args a, bool vec16) {
  tc::tc_body<2, MODE>(a, vec16);
}

// BANK: dq_bmm's kernel for P 1 (else dq_mm's)
template <int P, int MODE, bool BANK>
int launch_tc(const tc::Args& a, int experts, cudaStream_t st) {
  using L = tc::Tile<P, MODE>;
  auto kernel = P == 2 ? dq4_mm_tc_kernel<MODE>
                       : BANK ? dq_bmm_tc_kernel<MODE> : dq_mm_tc_kernel<MODE>;
  // the kernel's attributes, once per device: its shared memory, and
  // clusters of up to 16 CTAs (the H100's non-portable size)
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(configured >> dev & 1u))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + L::BN - 1) / L::BN * a.splits, (a.m + L::XR - 1) / L::XR, experts);
  if (a.splits == 1) {
    kernel<<<grid, L::kThreads, L::kSmem, st>>>(a, a.n % 16 == 0);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the splits of one tile: one cluster
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, a.n % 16 == 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tile codes of kernels/quant.py ``TILE_CODES``: 0 the SIMT tile above,
// 1 / 2 the small tile for <= 8 / <= 16 rows, 3 the large tile.  Which tile
// and how many splits a product takes is the wrapper's plan (dq_plan); the
// entry points refuse only what the tiles cannot run at all, or not within
// chip_smoke.py's tolerance: a dtype other than bf16, weight rows of no whole
// 8 bytes, stored rows of no whole k16 steps, splits that are no cluster of
// 1-16 CTAs each given at least one unit (tc_body) of the `stored` weight
// rows, or large-tile splits of more than kLargeSteps k16 steps.
// The large tile keeps at most kLargeSteps k16 steps (of the `planes` x
// `stored` rows of K) in one split's accumulator, whose f32 sums do not round
// as f32 additions do: at 256 an output that cancelled strayed beyond
// chip_smoke.py's tolerance (kernels/quant.py LARGE_STEPS).
constexpr int kLargeSteps = 128;
bool tc_args_ok(int tile, int dtype, int n, int stored, int planes, int unit, int splits) {
  const int units = (stored + unit - 1) / unit;
  return tile >= 1 && tile <= 3 && dtype == 1 && n % 8 == 0 && stored % 16 == 0
         && splits >= 1 && splits <= 16 && (splits & (splits - 1)) == 0 && splits <= units
         && (tile != 3 || planes * stored / 16 <= kLargeSteps * splits);
}

template <int P, bool BANK>
int dispatch_tc(const tc::Args& a, int tile, int experts, cudaStream_t st) {
  if (tile == 1) return launch_tc<P, 0, BANK>(a, experts, st);
  if (tile == 2) return launch_tc<P, 1, BANK>(a, experts, st);
  return launch_tc<P, 2, BANK>(a, experts, st);
}

// ---------------------------------------------------------------------------
// sdpa_int8
// ---------------------------------------------------------------------------

// A runtime call's error code for the wrapper, cleared from the runtime's
// last error, which the next launch's cudaGetLastError would report again
inline int refused(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

#ifdef DECODE_ATTN_ONE_CTA
namespace one_cta {

constexpr int RT = 4;  // query rows per pass of the PV phase

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
sdpa_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                 const float* __restrict__ ks, const int8_t* __restrict__ v8,
                 const float* __restrict__ vs, const int* __restrict__ pos,
                 T* __restrict__ out, int kvh, int gc, int c, int L, float scale) {
  constexpr int LPR = HD / 16;           // lanes per cache row
  constexpr int RPW = 32 / LPR;          // cache rows per warp step
  constexpr int RSTEP = RPW * kWarps;    // cache rows per CTA step
  extern __shared__ float smem[];
  float* qs = smem;                      // (gc, HD)
  float* sc = qs + gc * HD;              // (gc, L): scores, then rounded p * vs
  float* red = sc + static_cast<size_t>(gc) * L;  // (kWarps, RT, HD)

  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, d0 = (lane % LPR) * 16;
  const int p = pos[b];
  // keys past pos + c - 1 are masked for every row: exactly zero weight.
  // A negative pos may leave a row with no visible key, whose softmax is
  // uniform over all L, so then every key is read.
  const int l_end = p >= 0 ? min(L, p + c) : L;

  const T* qb = q + bh * gc * HD;
  for (int i = threadIdx.x; i < gc * HD; i += kThreads) qs[i] = to_f(qb[i]);
  __syncthreads();

  // phase 1: scores
  const int8_t* kb = k8 + bh * L * HD;
  const float* ksb = ks + bh * L;
  for (int l0 = 0; l0 < l_end; l0 += RSTEP) {
    const int l = l0 + warp * RPW + sub;
    int8_t kv[16];
    load16<true>(kb + static_cast<size_t>(min(l, L - 1)) * HD, d0, HD, kv);
    const float sk = l < l_end ? ksb[l] * scale : 0.f;
    for (int r = 0; r < gc; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) part = fmaf(qs[r * HD + d0 + j], static_cast<float>(kv[j]), part);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
      if (lane % LPR == 0 && l < l_end)
        sc[static_cast<size_t>(r) * L + l] = l <= p + r % c ? part * sk : kNegInf;
    }
  }
  __syncthreads();

  // phase 2: softmax of each row by one warp; the row becomes round(p * vs)
  const float* vsb = vs + bh * L;
  for (int r = warp; r < gc; r += kWarps) {
    float* row = sc + static_cast<size_t>(r) * L;
    float mx = kNegInf;
    for (int l = lane; l < l_end; l += 32) mx = fmaxf(mx, row[l]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.f;
    for (int l = lane; l < l_end; l += 32) sum += expf(row[l] - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    for (int l = lane; l < l_end; l += 32)
      row[l] = round_to<T>(expf(row[l] - mx) / sum * vsb[l]);
  }
  __syncthreads();

  // phase 3: out = sum_l pv[r, l] * v8[l, :], RT query rows per pass
  const int8_t* vb = v8 + bh * L * HD;
  T* ob = out + bh * gc * HD;
  for (int r0 = 0; r0 < gc; r0 += RT) {
    float acc[RT][16];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[rr][j] = 0.f;
    for (int l0 = 0; l0 < l_end; l0 += RSTEP) {
      const int l = l0 + warp * RPW + sub;
      if (l < l_end) {
        int8_t vv[16];
        load16<true>(vb + static_cast<size_t>(l) * HD, d0, HD, vv);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          if (r0 + rr < gc) {
            const float pv = sc[static_cast<size_t>(r0 + rr) * L + l];
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[rr][j] = fmaf(pv, static_cast<float>(vv[j]), acc[rr][j]);
          }
        }
      }
    }
    // lanes with the same d0 hold other rows of the cache: sum them
#pragma unroll
    for (int rr = 0; rr < RT; ++rr)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = acc[rr][j];
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
        acc[rr][j] = v;
      }
    if (sub == 0) {
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
#pragma unroll
        for (int j = 0; j < 16; ++j) red[(warp * RT + rr) * HD + d0 + j] = acc[rr][j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RT * HD; i += kThreads) {
      const int rr = i / HD, d = i % HD;
      if (r0 + rr < gc) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * RT + rr) * HD + d];
        ob[(r0 + rr) * HD + d] = from_f<T>(sum);
      }
    }
    __syncthreads();
  }
}

template <typename T, int HD>
int launch_sdpa(const void* q, const void* k8, const void* ks, const void* v8,
                const void* vs, const void* pos, void* out, int b, int kvh, int gc,
                int c, int L, float scale, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(gc) * HD + static_cast<size_t>(gc) * L
                       + static_cast<size_t>(kWarps) * RT * HD) * sizeof(float);
  auto kernel = sdpa_int8_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return refused(e);
  }
  kernel<<<dim3(kvh, b), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<T*>(out), kvh, gc, c, L, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sdpa_dispatch(int hd, const void* q, const void* k8, const void* ks,
                  const void* v8, const void* vs, const void* pos, void* out,
                  int b, int kvh, int gc, int c, int L, float scale, cudaStream_t st) {
  if (hd == 128) return launch_sdpa<T, 128>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, st);
  if (hd == 64) return launch_sdpa<T, 64>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, st);
  if (hd == 256) return launch_sdpa<T, 256>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace one_cta
#else

namespace dattn {

using namespace sm90;

constexpr int UNIT = 16;       // a split's keys start on 16-key boundaries
constexpr int NST = 4;         // ring stages
constexpr int kStage = 16384;  // bytes per stage: 16384 / hd cache lines

template <int HD>
struct Cfg {
  static constexpr int KC = kStage / HD;     // keys per stage: 256, 128, 64
  static constexpr int KL = HD / 16;         // lanes per key in the scores (16 codes each)
  static constexpr int KPP = kThreads / KL;  // keys per pass of the scores: 64, 32, 16
  static constexpr int CG = HD / 4;          // threads per key in the PV (4 codes each)
  static constexpr int KP = kThreads / CG;   // keys in parallel in the PV: 16, 8, 4
  static_assert(KC % KPP == 0 && KC % (4 * KP) == 0, "thread layouts");
  static_assert(KP * 8 * HD * 4 <= NST * kStage, "the PV reduction within the ring");
};

// keys per split: UNIT * ceil(ceil(L / UNIT) / S)
__host__ __device__ constexpr int split_keys(int L, int splits) {
  return UNIT * (((L + UNIT - 1) / UNIT + splits - 1) / splits);
}

// Shared memory: the ring, the receive buffer [RB * HD], q [gc][HD] in f32,
// the scores [gc][split_keys], the splits' row maxima and sums [S][gc]
// each, this CTA's and the global ones [4][gc], then the stages' mbarriers
// (kernels/quant.py sdpa_int8_plan states the same sum)
template <int HD, int RB>
constexpr long long smem_bytes(int gc, int L, int splits) {
  return NST * kStage
         + (4ll * (RB * HD + gc * HD + static_cast<long long>(gc) * split_keys(L, splits)
                   + 2 * splits * gc + 4 * gc) + 7) / 8 * 8
         + 8 * NST;
}

// the 4 codes of w as floats, exactly (tc::byte_code)
__device__ __forceinline__ void codes4(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;  // code + 128 in each byte
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  f[0] = tc::byte_code<0>(u, kBias);
  f[1] = tc::byte_code<1>(u, kBias);
  f[2] = tc::byte_code<2>(u, kBias);
  f[3] = tc::byte_code<3>(u, kBias);
}

template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kThreads, 1)
sdpa_int8_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                       const float* __restrict__ ks, const int8_t* __restrict__ v8,
                       const float* __restrict__ vs, const int* __restrict__ pos,
                       T* __restrict__ out, int kvh, int gc, int c, int L, float scale) {
  using C = Cfg<HD>;
  constexpr int RS = RB < 4 ? RB : 4;  // query rows per block of the scores
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = gridDim.x, s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int SL = split_keys(L, S);
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* recv = reinterpret_cast<float*>(smem + NST * kStage);  // [S][RB * HD / S]
  float* qs = recv + RB * HD;   // [gc][HD]
  float* sc = qs + gc * HD;     // [gc][SL]: scores, then round(p * vs)
  float* xm = sc + static_cast<size_t>(gc) * SL;  // [S][gc]: each split's row maxima
  float* xs = xm + S * gc;      // [S][gc]: each split's row sums
  float* lmax = xs + S * gc;    // [gc] this split's
  float* gmax = lmax + gc;      // [gc] the cluster's
  float* lsum = gmax + gc;
  float* gsum = lsum + gc;
  const unsigned bars = (smem_addr(gsum + gc) + 7) & ~7u;
  const unsigned ring_s = smem_addr(ring);

  if (tid < NST) mbar_init(bars + 8 * tid, 1);
  mbar_init_fence();
  __syncthreads();
  if (S > 1) cluster_arrive_relaxed();  // this CTA's shared memory is there for its peers

  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int p = pos[b];
  // keys past pos + c - 1 are masked for every row: exactly zero weight.
  // A negative pos may leave a row with no visible key, whose softmax is
  // uniform over all L, so then every key is read.
  const int l_end = p >= 0 ? min(L, p + c) : L;
  const int units = (l_end + UNIT - 1) / UNIT;
  const int k0 = UNIT * (s * units / S);
  const int nk = max(min(UNIT * ((s + 1) * units / S), l_end) - k0, 0);
  const int chunks = (nk + C::KC - 1) / C::KC;

  // stage u % NST takes chunk t of this split's K or V lines
  auto issue = [&](const int8_t* lines, int t, int u) {
    const int kb = t * C::KC, n = min(C::KC, nk - kb);
    const unsigned bar = bars + 8 * (u % NST);
    mbar_expect_tx(bar, n * HD);
    bulk_load(ring_s + (u % NST) * kStage, lines + (bh * L + k0 + kb) * HD, n * HD, bar);
  };
  // this CTA's row values into row `s` of every peer's [S][gc], then the
  // cluster barrier
  auto exchange = [&](const float* mine, float* peers) {
    for (int i = tid; i < S * gc; i += kThreads) {
      const unsigned j = i / gc;
      const int r = i % gc;
      st_cluster(cluster_map(smem_addr(peers + s * gc + r), j), mine[r]);
    }
    cluster_barrier();
  };

  if (tid == 0)
    for (int t = 0; t < NST - 1 && t < chunks; ++t) issue(k8, t, t);
  for (int i = tid; i < gc * HD; i += kThreads) qs[i] = to_f(q[bh * gc * HD + i]);

  // phase 1: scores (q . k8) * ks * scale of this split's keys, KL lanes per
  // key, the query rows in blocks of RS held in registers
  const int kl = tid % C::KL, kq = tid / C::KL, d0 = 16 * kl;
  const float* ksb = ks + bh * L + k0;
  int u = 0;  // this CTA's tiles so far
  for (int t = 0; t < chunks; ++t, ++u) {
    __syncthreads();  // tile t - 1's stage is free (and q is staged)
    if (tid == 0 && t + NST - 1 < chunks) issue(k8, t + NST - 1, u + NST - 1);
    mbar_wait(bars + 8 * (u % NST), (u / NST) & 1);
    const int8_t* tile = ring + (u % NST) * kStage;
    const int kb = t * C::KC, n = min(C::KC, nk - kb);
    for (int r0 = 0; r0 < gc; r0 += RS) {
      float qr[RS][16];
#pragma unroll
      for (int r = 0; r < RS; ++r)
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r0 + r < gc) v = *reinterpret_cast<const float4*>(qs + (r0 + r) * HD + d0 + j);
          qr[r][j] = v.x;
          qr[r][j + 1] = v.y;
          qr[r][j + 2] = v.z;
          qr[r][j + 3] = v.w;
        }
      // every pass of the stage, those past a short last stage on a clamped
      // key whose score is not stored: no branch between the passes
#pragma unroll
      for (int kk0 = 0; kk0 < C::KC; kk0 += C::KPP) {
        const int kk = min(kk0 + kq, n - 1);
        const uint4 raw = *reinterpret_cast<const uint4*>(tile + kk * HD + d0);
        float kf[16];
        codes4(raw.x, kf);
        codes4(raw.y, kf + 4);
        codes4(raw.z, kf + 8);
        codes4(raw.w, kf + 12);
        float part[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int j = 0; j < 16; j += 2) {
            a0 = fmaf(qr[r][j], kf[j], a0);
            a1 = fmaf(qr[r][j + 1], kf[j + 1], a1);
          }
          part[r] = a0 + a1;
        }
#pragma unroll
        for (int off = C::KL / 2; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < RS; ++r) part[r] += __shfl_xor_sync(kFull, part[r], off);
        const int li = kb + kk, l = k0 + li;
        const float sk = __ldg(ksb + li) * scale;  // a clamped key: loads may issue early
        if (kl == 0 && kk0 + kq < n) {
#pragma unroll
          for (int r = 0; r < RS; ++r)
            if (r0 + r < gc)
              sc[static_cast<size_t>(r0 + r) * SL + li] =
                  l <= p + (r0 + r) % c ? part[r] * sk : kNegInf;
        }
      }
    }
  }
  __syncthreads();  // every score is written; the ring is free
  // V's first stages copy while the cluster exchanges the softmax statistics
  if (tid == 0)
    for (int t = 0; t < NST - 1 && t < chunks; ++t) issue(v8, t, u + t);

  // phase 2: the softmax over the cluster's keys.  The global max, then the
  // global sum, each from the splits' values in rank order
  for (int r = warp; r < gc; r += kWarps) {
    const float* row = sc + static_cast<size_t>(r) * SL;
    float mx = kNegInf;
    for (int l = lane; l < nk; l += 32) mx = fmaxf(mx, row[l]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (lane == 0) lmax[r] = mx;
  }
  __syncthreads();
  if (S > 1) {
    cluster_wait();  // every peer has started
    exchange(lmax, xm);
    for (int r = tid; r < gc; r += kThreads) {
      float m = xm[r];
      for (int j = 1; j < S; ++j) m = fmaxf(m, xm[j * gc + r]);
      gmax[r] = m;
    }
  } else {
    for (int r = tid; r < gc; r += kThreads) gmax[r] = lmax[r];
  }
  __syncthreads();
  for (int r = warp; r < gc; r += kWarps) {
    const float* row = sc + static_cast<size_t>(r) * SL;
    const float m = gmax[r];
    float sum = 0.f;
    for (int l = lane; l < nk; l += 32) sum += expf(row[l] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) lsum[r] = sum;
  }
  __syncthreads();
  if (S > 1) {
    exchange(lsum, xs);
    for (int r = tid; r < gc; r += kThreads) {
      float sum = xs[r];
      for (int j = 1; j < S; ++j) sum += xs[j * gc + r];
      gsum[r] = sum;
    }
  } else {
    for (int r = tid; r < gc; r += kThreads) gsum[r] = lsum[r];
  }
  __syncthreads();
  // each score becomes round(p * vs), as the plain version rounds it; zeros
  // up to the next 16 keys, which the PV reads 4 at a time
  const int nk16 = (nk + 15) / 16 * 16;
  const float* vsb = vs + bh * L + k0;
  for (int l0 = 0; l0 < nk16; l0 += 4 * kThreads) {
    float v[4];  // four keys' scales in flight at once
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + j * kThreads + tid;
      v[j] = l < nk ? __ldg(vsb + l) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + j * kThreads + tid;
      if (l < nk16)
        for (int r = 0; r < gc; ++r) {
          float* e = sc + static_cast<size_t>(r) * SL + l;
          *e = l < nk ? round_to<T>(expf(*e - gmax[r]) / gsum[r] * v[j]) : 0.f;
        }
    }
  }

  // phase 3: this split's sum_l pv[r, l] * v8[l, :], 4 codes per thread, the
  // query rows in blocks of RB (V streamed once per block)
  const int cg = tid % C::CG, kp = tid / C::CG;
  for (int r0 = 0; r0 < gc; r0 += RB) {
    const int nr = min(RB, gc - r0);
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    if (r0 > 0 && tid == 0)
      for (int t = 0; t < NST - 1 && t < chunks; ++t) issue(v8, t, u + t);
    for (int t = 0; t < chunks; ++t, ++u) {
      __syncthreads();  // tile t - 1's stage is free (and the p * vs are written)
      if (tid == 0 && t + NST - 1 < chunks) issue(v8, t + NST - 1, u + NST - 1);
      mbar_wait(bars + 8 * (u % NST), (u / NST) & 1);
      const int8_t* tile = ring + (u % NST) * kStage;
      const int kb = t * C::KC, n = min(C::KC, nk - kb);
      // every step of the stage; past a short last stage p is 0
#pragma unroll
      for (int kk0 = 0; kk0 < C::KC; kk0 += 4 * C::KP) {
        const int kk = kk0 + 4 * kp;
        const bool live = kk < n;
        float vf[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          codes4(*reinterpret_cast<const unsigned*>(tile + (kk + i) * HD + 4 * cg), vf[i]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const float4 pv =
                live ? *reinterpret_cast<const float4*>(sc + static_cast<size_t>(r0 + r) * SL + kb + kk)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[r][e] = fmaf(pv.x, vf[0][e], acc[r][e]);
              acc[r][e] = fmaf(pv.y, vf[1][e], acc[r][e]);
              acc[r][e] = fmaf(pv.z, vf[2][e], acc[r][e]);
              acc[r][e] = fmaf(pv.w, vf[3][e], acc[r][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // every tile is used: the ring takes the key groups' partials
    float* red = reinterpret_cast<float*>(smem);  // [KP][RB][HD]
#pragma unroll
    for (int r = 0; r < RB; ++r)
      *reinterpret_cast<float4*>(red + (kp * RB + r) * HD + 4 * cg) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    fence_proxy_async();  // before the next block's copies into the ring
    __syncthreads();

    const int T_ = nr * HD;
    T* ob = out + (bh * gc + r0) * HD;
    if (S == 1) {
      for (int i = tid; i < T_; i += kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::KP; ++j) sum += red[(j * RB + i / HD) * HD + i % HD];
        ob[i] = from_f<T>(sum);
      }
    } else {
      // the splits' partials summed in rank order: slice r of the rows to
      // CTA r (row s of its [S][T / S]), then each CTA writes its slice
      const int slice = T_ / S;
      for (int i = 4 * tid; i < T_; i += 4 * kThreads) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < C::KP; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(red + (j * RB + i / HD) * HD + i % HD);
          v.x += a.x;
          v.y += a.y;
          v.z += a.z;
          v.w += a.w;
        }
        const int owner = i / slice;
        st_cluster4(cluster_map(smem_addr(recv + s * slice + i - owner * slice), owner), v);
      }
      cluster_barrier();
      for (int k = 4 * tid; k < slice; k += 4 * kThreads) {
        float4 o = *reinterpret_cast<const float4*>(recv + k);
        for (int j = 1; j < S; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(recv + j * slice + k);
          o.x += a.x;
          o.y += a.y;
          o.z += a.z;
          o.w += a.w;
        }
        T* o4 = ob + s * slice + k;
        o4[0] = from_f<T>(o.x);
        o4[1] = from_f<T>(o.y);
        o4[2] = from_f<T>(o.z);
        o4[3] = from_f<T>(o.w);
      }
      if (r0 + RB < gc) cluster_barrier();  // the receive buffer is read before reuse
    }
    __syncthreads();
  }
}

// The launch, or with `clusters` the count of whole clusters the card can
// hold at once (cudaOccupancyMaxActiveClusters) written there instead.
// `smem` is the plan's (kernels/quant.py sdpa_int8_plan), held to the
// kernel's; the kernel's attributes are set once per device.
template <typename T, int HD, int RB>
int launch(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
           const void* pos, void* out, int b, int kvh, int gc, int c, int L, float scale,
           int splits, int smem, int* clusters, cudaStream_t st) {
  if (splits < 1 || splits > 16 || (splits & (splits - 1)) || smem > 232448
      || smem != smem_bytes<HD, RB>(gc, L, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sdpa_int8_split_kernel<T, HD, RB>;
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(configured >> dev & 1u))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
  }
  if (err != cudaSuccess) return refused(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config(dim3(splits, kvh, b), kThreads, smem, st, attr);
  if (clusters)
    return refused(
        cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg));
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const int8_t*>(k8),
                           static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
                           static_cast<const float*>(vs), static_cast<const int*>(pos),
                           static_cast<T*>(out), kvh, gc, c, L, scale);
  if (err != cudaSuccess) return refused(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rows(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
            const void* pos, void* out, int b, int kvh, int gc, int c, int L, float scale,
            int rows, int splits, int smem, int* clusters, cudaStream_t st) {
  if (rows == 1)
    return launch<T, HD, 1>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, splits, smem,
                            clusters, st);
  if (rows == 2)
    return launch<T, HD, 2>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, splits, smem,
                            clusters, st);
  if (rows == 4)
    return launch<T, HD, 4>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, splits, smem,
                            clusters, st);
  if (rows == 8)
    return launch<T, HD, 8>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, splits, smem,
                            clusters, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int hd, const void* q, const void* k8, const void* ks, const void* v8,
             const void* vs, const void* pos, void* out, int b, int kvh, int gc, int c, int L,
             float scale, int rows, int splits, int smem, int* clusters, cudaStream_t st) {
  if (hd == 128)
    return by_rows<T, 128>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, rows, splits,
                           smem, clusters, st);
  if (hd == 64)
    return by_rows<T, 64>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, rows, splits,
                          smem, clusters, st);
  if (hd == 256)
    return by_rows<T, 256>(q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, rows, splits,
                           smem, clusters, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dattn
#endif

}  // namespace

// dq_mm, dq_bmm and dq4_mm launch on the tile and K splits of `tile` and
// `splits` (kernels/quant.py dq_plan); tile 0 is the SIMT tile.
extern "C" int dq_mm(const void* x, const void* q, const void* s, void* out,
                     int m, int n, int k, int tile, int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef DQ_SIMT_BF16
  tile = 0;
#endif
  if (tile == 0) {
    if (dtype == 1) return launch_dq<__nv_bfloat16>(false, x, q, s, out, 0, m, n, k, 0, st);
    return launch_dq<float>(false, x, q, s, out, 0, m, n, k, 0, st);
  }
  if (!tc_args_ok(tile, dtype, n, k, 1, tc::Tile<1, 0>::RB, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                   static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
                   m, n, k, 0, splits};
  return dispatch_tc<1, false>(a, tile, 1, st);
}

extern "C" int dq_bmm(const void* x, const void* q, const void* s, void* out,
                      int e, int c, int n, int k, int tile, int splits, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || e > 65535) return static_cast<int>(cudaErrorInvalidValue);
#ifdef DQ_SIMT_BF16
  tile = 0;
#endif
  if (tile == 0) {
    if (dtype == 1) return launch_dq<__nv_bfloat16>(false, x, q, s, out, e, c, n, k, 0, st);
    return launch_dq<float>(false, x, q, s, out, e, c, n, k, 0, st);
  }
  if (!tc_args_ok(tile, dtype, n, k, 1, tc::Tile<1, 0>::RB, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                   static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
                   c, n, k, 0, splits};
  return dispatch_tc<1, true>(a, tile, e, st);
}

extern "C" int dq4_mm(const void* x, const void* p, const void* s, void* out,
                      int m, int n, int k, int group, int tile, int splits, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % 2 || group < 1 || k % group) return static_cast<int>(cudaErrorInvalidValue);
#ifdef DQ_SIMT_BF16
  tile = 0;
#endif
  if (tile == 0) {
    if (dtype == 1) return launch_dq<__nv_bfloat16>(true, x, p, s, out, 0, m, n, k, group, st);
    return launch_dq<float>(true, x, p, s, out, 0, m, n, k, group, st);
  }
  if (!tc_args_ok(tile, dtype, n, k / 2, 2, group, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(p),
                   static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
                   m, n, k, group, splits};
  return dispatch_tc<2, false>(a, tile, 1, st);
}

// sdpa_int8 on the launch plan of kernels/quant.py sdpa_int8_plan: query
// rows in blocks of `rows` (1, 2, 4 or 8), `splits` CTAs per (batch row, kv
// head) and `smem` bytes of shared memory each (ignored by the
// -DDECODE_ATTN_ONE_CTA build).
extern "C" int sdpa_int8(const void* q, const void* k8, const void* ks,
                         const void* v8, const void* vs, const void* pos, void* out,
                         int b, int kvh, int gc, int c, int hd, int L, float scale,
                         int rows, int splits, int smem, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
#ifdef DECODE_ATTN_ONE_CTA
  (void)rows, (void)splits, (void)smem;
  if (dtype == 1)
    return one_cta::sdpa_dispatch<__nv_bfloat16>(hd, q, k8, ks, v8, vs, pos, out, b, kvh, gc, c,
                                                 L, scale, st);
  return one_cta::sdpa_dispatch<float>(hd, q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale,
                                       st);
#else
  if (dtype == 1)
    return dattn::dispatch<__nv_bfloat16>(hd, q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L,
                                          scale, rows, splits, smem, nullptr, st);
  return dattn::dispatch<float>(hd, q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, rows,
                                splits, smem, nullptr, st);
#endif
}

// How many clusters of the plan the card holds at once (into *clusters),
// for chip_smoke.py's split A/B; an error code where the plan is refused.
extern "C" int sdpa_int8_clusters(int gc, int hd, int L, int rows, int splits, int smem,
                                  int dtype, int* clusters) {
#ifdef DECODE_ATTN_ONE_CTA
  (void)gc, (void)hd, (void)L, (void)rows, (void)splits, (void)smem, (void)dtype, (void)clusters;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (dtype == 1)
    return dattn::dispatch<__nv_bfloat16>(hd, nullptr, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, 1, 1, gc, 1, L, 1.f, rows, splits,
                                          smem, clusters, 0);
  return dattn::dispatch<float>(hd, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, 1, 1, gc, 1, L, 1.f, rows, splits, smem, clusters, 0);
#endif
}
