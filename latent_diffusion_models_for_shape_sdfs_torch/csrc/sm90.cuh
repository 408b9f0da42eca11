// Hopper (sm_90a) primitives shared by the port's wgmma kernels
// (csrc/fused_eval_pairs.cu, csrc/fused_train.cu): shared-memory
// addresses, wgmma shared-memory descriptors (no swizzle K-major; 128-byte
// swizzle K-major and MN-major), mbarriers, bulk and tensor (TMA) copies,
// clusters, proxy fences, setmaxnreg, and the wgmma products themselves.

#pragma once

#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major operand without swizzle: 8x8 core
// matrices of 128 contiguous bytes, `lbo` bytes to the next 8 of K,
// `sbo` bytes to the next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle layout
// that a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64 bf16
// (128 bytes), 16-byte chunk c of row r at chunk c ^ (r % 8), 8-row groups
// SW128_SBO bytes apart (the leading offset is unused: a k16 step lies in
// one 128-byte row). The tile starts 1024-byte aligned; a k16 step at
// element k0 of the row starts at tile + 2 * k0 (the swizzle applies to
// the address bits, so the base offset stays 0).
constexpr uint32_t SW128_SBO = 1024;

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(SW128_SBO >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// wgmma descriptor of an MN-major operand (M or N contiguous, read with
// the transpose bit set) in the 128-byte swizzle layout that a TMA box of
// 64 MN elements (one 128-byte row) x K rows writes: row k of an 8-row
// group at 128 k bytes, 16-byte chunk c of a row at c ^ (k % 8), 8-row
// groups of K SW128_SBO bytes apart, and 64-element MN atoms (the next
// box) `lbo` bytes apart. A k16 step starts at tile + 16 * 128 * step, two
// whole 8-row groups on, so the swizzle phase and the base offset stay 0.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(SW128_SBO >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// ---- mbarriers, bulk and tensor copies, cluster

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase after `parity`, spinning inside one asm block (no
// divergent C++ loop between the wgmmas); a wait of more than ~2 s (a
// broken pipeline) traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4000000000;\n"
      "@p trap;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// arrive on a barrier of this CTA if `pred` (predicated inside the asm: no
// divergent branch around the wgmmas)
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(pred)
      : "memory");
}

// arrive on the barrier at the same offset in CTA `cta` of the cluster if
// `pred` (predicated inside the asm: no divergent branch). Default
// semantics: a cluster-scope release would fence on every slab, and the
// slot's reads are already complete (wgmma.wait_group) when it arrives.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta,
                                                    uint32_t pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 ra;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          bar),
      "r"(cta), "r"(pred)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint16_t mask, bool multicast) {
  if (multicast)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// TMA: the box at element (x = inner, y = row) of the 2-D tensor map `map`
// (a __grid_constant__ kernel parameter) into shared memory at `dst`,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// TMA: the shared-memory box at `src` to element (x, y) of the 2-D tensor
// map `map`, in this thread's bulk async-group.
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// waits until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// named barrier 1 over the two consumer warpgroups
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// named barrier `id` over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy shared-memory writes -> visible to wgmma and TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- setmaxnreg: move registers between warpgroups

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- wgmma: D[64, NW] += A[64, 16] B[NW, 16]^T from shared memory, both
// operands K-major (TRANS = 0) or both MN-major (TRANS = 1: the transpose
// immediates imm-trans-a = imm-trans-b = 1, bf16 only)

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define SM90_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <int NW, int TRANS = 0>
struct Wgmma;

template <int TRANS>
struct Wgmma<32, TRANS> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %19;\n}\n"
      : SM90_F4(0), SM90_F4(4), SM90_F4(8), SM90_F4(12)
      : "l"(a), "l"(b), "r"(1), "n"(TRANS));
  }
};

template <int TRANS>
struct Wgmma<64, TRANS> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %35;\n}\n"
      : SM90_F4(0), SM90_F4(4), SM90_F4(8), SM90_F4(12), SM90_F4(16),
        SM90_F4(20), SM90_F4(24), SM90_F4(28)
      : "l"(a), "l"(b), "r"(1), "n"(TRANS));
  }
};

template <int TRANS>
struct Wgmma<128, TRANS> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : SM90_F4(0), SM90_F4(4), SM90_F4(8), SM90_F4(12), SM90_F4(16),
        SM90_F4(20), SM90_F4(24), SM90_F4(28), SM90_F4(32), SM90_F4(36),
        SM90_F4(40), SM90_F4(44), SM90_F4(48), SM90_F4(52), SM90_F4(56),
        SM90_F4(60)
      : "l"(a), "l"(b), "r"(1), "n"(TRANS));
  }
};

template <int TRANS>
struct Wgmma<256, TRANS> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
      : SM90_F4(0), SM90_F4(4), SM90_F4(8), SM90_F4(12), SM90_F4(16),
        SM90_F4(20), SM90_F4(24), SM90_F4(28), SM90_F4(32), SM90_F4(36),
        SM90_F4(40), SM90_F4(44), SM90_F4(48), SM90_F4(52), SM90_F4(56),
        SM90_F4(60), SM90_F4(64), SM90_F4(68), SM90_F4(72), SM90_F4(76),
        SM90_F4(80), SM90_F4(84), SM90_F4(88), SM90_F4(92), SM90_F4(96),
        SM90_F4(100), SM90_F4(104), SM90_F4(108), SM90_F4(112),
        SM90_F4(116), SM90_F4(120), SM90_F4(124)
      : "l"(a), "l"(b), "r"(1), "n"(TRANS));
  }
};

#undef SM90_F4

}  // namespace sm90
