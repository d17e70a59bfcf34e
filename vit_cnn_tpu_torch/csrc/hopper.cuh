// Hopper-only helpers of V3 (heads_variants.cu): mbarriers,
// one-dimensional TMA bulk copies completed on an mbarrier, and warpgroup
// MMA (wgmma) with its shared-memory descriptors. sm_90a (wgmma exists
// only there).
#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace vct {

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device to shared memory, completed on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle layout: rows of 64 bf16 (128 bytes), 8-row atoms of 1,024 bytes
// (the atom's base 1,024-byte aligned), so the stride between 8-row groups
// is 1,024 bytes. A k16 slice at byte offset 32 j of the row starts at
// p + 32 j (the hardware applies the swizzle to the final address).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins an accumulator register to this point of the program, so that no
// access to it moves across a wgmma fence or wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// D (64 x 8 per call, f32) = A (64 x 16 bf16, registers: a warp's 16 rows
// in the mma.sync A-fragment layout) . B (16 x 8 from the K-major
// descriptor), accumulate: the warp's lane holds rows g, g + 8 and
// columns 2 t, 2 t + 1, as mma.sync's D fragment
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// D (64 x 64) into the n8 groups J .. J + 7 of d, as wgmma_n8 lays out
// each group (B: 64 K-major rows from the descriptor, 8 rows an atom)
template <int J, int NG>
__device__ __forceinline__ void wgmma_n64(float (&d)[NG][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  static_assert(J + 8 <= NG, "wgmma_n64 writes 8 groups");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[J][0]), "+f"(d[J][1]), "+f"(d[J][2]), "+f"(d[J][3]),
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]), "+f"(d[J + 1][2]),
        "+f"(d[J + 1][3]), "+f"(d[J + 2][0]), "+f"(d[J + 2][1]),
        "+f"(d[J + 2][2]), "+f"(d[J + 2][3]), "+f"(d[J + 3][0]),
        "+f"(d[J + 3][1]), "+f"(d[J + 3][2]), "+f"(d[J + 3][3]),
        "+f"(d[J + 4][0]), "+f"(d[J + 4][1]), "+f"(d[J + 4][2]),
        "+f"(d[J + 4][3]), "+f"(d[J + 5][0]), "+f"(d[J + 5][1]),
        "+f"(d[J + 5][2]), "+f"(d[J + 5][3]), "+f"(d[J + 6][0]),
        "+f"(d[J + 6][1]), "+f"(d[J + 6][2]), "+f"(d[J + 6][3]),
        "+f"(d[J + 7][0]), "+f"(d[J + 7][1]), "+f"(d[J + 7][2]),
        "+f"(d[J + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

}  // namespace vct
