// Hopper building blocks shared by quant.cu, flash_fwd.cu, flash_bwd.cu,
// matmul.cu, paged.cu and scan.cu: the lookup of the TMA map encoder,
// cp.async and TMA bulk copies into shared memory,
// mbarriers, thread-block clusters and their distributed shared memory,
// the matrix descriptors of operands staged there, the warpgroup MMAs
// (wgmma) the kernels run, and the flash kernels' swizzled tile copy and
// product loops.
//
// Operands live in shared memory in one of two layouts.  quant.cu stores
// them unswizzled (desc), as 8-row x 16-byte core matrices (128 contiguous
// bytes: 8 rows of 8 bf16); the flash kernels store them in 128-byte
// swizzle atoms (desc_sw128, below).  For the unswizzled layout: a K-major operand
// (the contraction dimension contiguous: A = Q, B = K or x) and an
// MN-major one (B = V, whose output dimension is contiguous) are both
// described by the byte distance between core matrices adjacent along K
// (LBO) and along M or N (SBO).  A tile of R rows x C bf16 columns stored
// as [R / 8][C / 8][8 rows][16 bytes] gives LBO 128, SBO C * 16 when C is
// the contraction dimension, and the other way round when it is not.

#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is found at run time, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                           const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                           const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                           CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (null where it has none), for the TMA tensor maps of matmul.cu and scan.cu
inline Encode encoder() {
  static Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(p)
               : nullptr;
  }();
  return fn;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory into shared memory; src_bytes 0 fills the
// destination with zeros (rows past the operand's end)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes (one f32) likewise, through L1 (.cg takes only 16)
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes made visible to the tensor cores'
// reads through descriptors (the async proxy); a barrier then publishes
// them to the other threads' MMAs
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory.  A wait names the parity of the phase it
// waits to complete: a fresh barrier is in phase 0, so waiting on parity 1
// returns at once.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the inits made visible before any thread uses the barriers (then a
// __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive once every cp.async this thread issued before has landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the next arrival on mbarrier `bar` also expects `bytes` of copies (TMA)
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) of contiguous global memory into shared memory
// by the TMA, completing a transaction of mbarrier `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Thread-block clusters.  A CTA's rank in its cluster, and the cluster's
// barrier (every thread of every CTA), whole or as its two halves: a CTA
// arrives once it has started (its shared memory may then be written by
// its peers) and waits before its first store into a peer's.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared address `addr` of this CTA, as the same offset in CTA `rank`
// of the cluster
__device__ __forceinline__ unsigned cluster_map(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
// A launch of `grid` whose x extent is one cluster (the splits of one
// output), with its attribute in attr[0]
inline cudaLaunchConfig_t split_config(dim3 grid, int threads, int smem, cudaStream_t st,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}
__device__ __forceinline__ void st_cluster4(unsigned addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads:
// sync waits for all of them, arrive counts this warp in without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The matrix descriptor of an unswizzled operand at shared address `addr`:
// core matrices `lbo` bytes apart along K and `sbo` bytes apart along M or
// N; fields in 16-byte units.  Adding b / 16 to a descriptor moves its
// start b bytes on.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// The descriptor of an operand stored in 128-byte swizzle atoms: 8 rows
// of 128 bytes (64 bf16) whose 16-byte chunk c of row r lies at c ^ (r % 8),
// atoms 1024-byte aligned.  K-major: `sbo` bytes between 8-row groups, the
// start moved 32 bytes on per 16 columns inside an atom.  MN-major: `lbo`
// bytes between atoms along M or N (64 columns each), `sbo` between groups
// of 8 rows along K.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr, unsigned lbo, unsigned sbo) {
  return desc(addr, lbo, sbo) | 1ull << 62;
}

// registers moved from the producer warpgroup to the consumers (every warp
// of a warpgroup executes it)
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep registers that asynchronous MMAs write or read where they are,
// and no use of them before the wait that precedes this
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// In each MMA below, d (f32) = a . b + (accumulate ? d : 0).  The first MMA
// of a tile defines the accumulators (accumulate 0), so that no other
// instruction writes them while MMAs are in flight (ptxas otherwise
// serialises the MMAs).  Thread t of the warpgroup holds d[4j + i] at row
// 16 (t / 32) + (t % 32) / 4 (+ 8 for i >= 2), column 8 j + 2 (t % 4)
// (+ 1 for odd i).

// d (64 x 128) from a (64 x 16 bf16, registers: the fragment of
// mma.sync's m16n8k16 A for each warp's 16 rows) and b (16 x 128 bf16,
// shared memory; TRANS_B 1 for an MN-major b)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const unsigned (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x N) from a (64 x 16) and b (16 x N), both in shared memory:
// K-major (TRANS 0: the contraction dimension contiguous) or MN-major
// (TRANS 1: M or N contiguous)
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 64) from a (64 x 16) and b (16 x 64), both K-major in shared
// memory
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// two f32 values as bf16x2 (lo in the low half), each rounded to nearest
// even
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The flash kernels' tiles: R rows x D bf16 columns in D / 64 swizzle atoms
// of R rows x 128 bytes, one atom after the other (atom a holds columns
// 64a..64a+63).
//
// Copy rows [r0, r0 + R) of a (rows, D) bf16 matrix into the tile at
// shared address `dst`, zeros for rows >= limit.  Copier t of T copies the
// 16-byte chunks i = t + j T: chunk i % 8 of row (i / 8) % R in atom
// i / (8 R), at 16 i with the chunk index swizzled by the row: 8 copiers
// fill one 128-byte row, read contiguously from global memory.
template <int D, int R, int T>
__device__ __forceinline__ void load_tile(unsigned dst, const __nv_bfloat16* src, int r0,
                                          int limit, int t) {
#pragma unroll 4
  for (int j = 0; j < R * D / 8 / T; ++j) {
    const int i = t + j * T, r = (i / 8) % R;
    const bool ok = r0 + r < limit;
    cp_async16(dst + ((16 * i) ^ ((r & 7) << 4)),
               ok ? src + static_cast<size_t>(r0 + r) * D + (i / (8 * R)) * 64 + (i % 8) * 8
                  : src,
               ok ? 16 : 0);
  }
}

// S (a warpgroup's 64 rows x N, f32) = A B^T over D, both K-major tiles:
// A's 64 rows at shared address `a` inside a tile of R rows, B a tile of N
// rows at `b`.  Issued only: the caller fences before and commits after.
template <int D, int N, int R>
__device__ __forceinline__ void qk(float (&s)[N / 2], unsigned a, unsigned b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned off = (kk % 4) * 32;
    const uint64_t da = desc_sw128(a + (kk / 4) * R * 128 + off, 16, 1024);
    const uint64_t db = desc_sw128(b + (kk / 4) * N * 128 + off, 16, 1024);
    if constexpr (N == 128) wgmma_m64n128_ss(s, da, db, kk > 0);
    else wgmma_m64n64_ss(s, da, db, kk > 0);
  }
}

// O (64 x D) += P (64 x K, registers in the accumulator's layout: registers
// 4kk.. hold columns 16kk..) B (K x D at shared address `b`, a tile of K
// rows read MN-major: atoms of 64 columns K * 128 bytes apart, 8-row groups
// 1 KB apart), in blocks of 128 columns.  Issued only, as qk.
template <int D, int K>
__device__ __forceinline__ void pv(float (&o)[D / 128][64], const unsigned (&p)[K / 4],
                                   unsigned b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const unsigned a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
      wgmma_m64n128_rs<1>(o[h], a, desc_sw128(b + kk * 2048 + h * 2 * K * 128, K * 128, 1024), 1);
  }
}

// Where element i of a warpgroup's accumulator lies, relative to this
// thread's first column (+ 2 (lane % 4)) and first row (16 warp + lane / 4)
template <int I>
struct Elem {
  static constexpr int col = 8 * (I / 4) + I % 2;
  static constexpr int row = 8 * ((I / 2) % 2);
};

}  // namespace sm90
