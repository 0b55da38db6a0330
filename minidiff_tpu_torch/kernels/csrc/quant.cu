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
// Bound on the H100: at decode (m = 8 activation rows) a dequant-matmul does
// 2*m = 16 flop per weight byte (32 for int4), far under the ~295 flop/byte
// ridge: it is bound by the bytes of the weight, which it must read once.
// Design: each CTA owns a 64-column tile of the output and 8 activation
// rows; its 8 warps split K, each lane streams 16 consecutive columns of one
// weight row with one 16-byte load (coalesced along N, 64 bytes per row per
// warp step) and keeps 8 x 16 f32 accumulators in registers, while the x rows
// are staged in shared memory in chunks of K.  Lanes of one warp sum by
// shuffle, the 8 warps through shared memory, and the epilogue scales and
// casts.  More than 8 rows (a prefill of up to 256) tile over blockIdx.y and
// re-read the weight from L2.  f32 inputs use FFMA (no TF32).  int4: the
// high nibble is an arithmetic shift of the sign-extended byte, the low one
// (b << 28) >> 28; row r belongs to group r / group, so the low plane reads
// groups [0, G/2) and the high plane [G/2, G).  A weight row that is no whole
// number of 16-byte vectors (N % 16 != 0) is read byte by byte.  dq_bmm runs
// dq_mm's tile with the expert as a third grid axis: blockIdx.z offsets x, q,
// s and the output by one expert's strides, so each expert's bank streams
// through its own CTAs, once per 8 rows of that expert's slots.
//
// sdpa_int8 at decode reads the int8 cache lines and their f32 scales once:
// (hd + 4) bytes per key for K and for V, bound by bytes.  Design: one CTA
// per (batch row, kv head); keys past the last visible one (pos + c - 1) are
// never read, since their probabilities are exactly 0.  Phase 1 streams key
// rows with 16-byte loads (hd / 16 lanes per row) and writes the f32 scores
// to shared memory; phase 2 runs each row's softmax with one warp and
// rewrites the scores as the rounded (p * vs); phase 3 streams the V rows the
// same way and sums across lanes and warps.  Head dims 64, 128 and 256 are
// instantiated (the JAX kernel takes any multiple of 128).  Splitting L
// across CTAs and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
#pragma unroll 2
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
// sdpa_int8
// ---------------------------------------------------------------------------

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
    if (e != cudaSuccess) return static_cast<int>(e);
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

}  // namespace

extern "C" int dq_mm(const void* x, const void* q, const void* s, void* out,
                     int m, int n, int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(false, x, q, s, out, 0, m, n, k, 0, st);
  return launch_dq<float>(false, x, q, s, out, 0, m, n, k, 0, st);
}

extern "C" int dq_bmm(const void* x, const void* q, const void* s, void* out,
                      int e, int c, int n, int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || e > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(false, x, q, s, out, e, c, n, k, 0, st);
  return launch_dq<float>(false, x, q, s, out, e, c, n, k, 0, st);
}

extern "C" int dq4_mm(const void* x, const void* p, const void* s, void* out,
                      int m, int n, int k, int group, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % 2 || group < 1 || k % group) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(true, x, p, s, out, 0, m, n, k, group, st);
  return launch_dq<float>(true, x, p, s, out, 0, m, n, k, group, st);
}

extern "C" int sdpa_int8(const void* q, const void* k8, const void* ks,
                         const void* v8, const void* vs, const void* pos, void* out,
                         int b, int kvh, int gc, int c, int hd, int L, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return sdpa_dispatch<__nv_bfloat16>(hd, q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, st);
  return sdpa_dispatch<float>(hd, q, k8, ks, v8, vs, pos, out, b, kvh, gc, c, L, scale, st);
}
