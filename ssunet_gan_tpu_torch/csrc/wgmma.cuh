// What the port's wgmma cores share (eval_conv.cuh: the bf16 eval convs;
// int8_conv.cuh: the s8 convs of the int8 stage): the wgmma fences, the
// bulk copy of a weight slice with its mbarrier, and the matrix descriptor
// of a K-major operand in shared memory without swizzle. Everything is in
// an anonymous namespace.

#pragma once

// The includer brings smem_u32 (stage_common.cuh or f32_conv.cuh) first.
#include <stdint.h>

namespace {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// cp.async writes (the generic proxy) made visible to wgmma's reads (the
// async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The weight slices arrive by bulk copy (the TMA engine, one instruction
// for the whole slice) and report to an mbarrier per ring slot.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// bytes of global memory at src into shared memory at dst (16-byte aligned,
// a multiple of 16), completing a phase of bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The matrix descriptor of a K-major operand without swizzle at shared
// address addr: core matrices of 8 rows x 16 bytes (8 bf16 or 16 s8 K
// values), the two K halves of a step (k16 bf16, k32 s8) lbo bytes apart,
// consecutive 8-row groups sbo bytes apart.
__device__ __forceinline__ uint64_t ec_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// keeps the compiler from moving accesses of v across the asm around it
// (the accumulators are written asynchronously between issue and wait)
__device__ __forceinline__ void reg_fence(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void reg_fence(int& v) { asm volatile("" : "+r"(v)::"memory"); }

}  // namespace
