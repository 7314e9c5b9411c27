// Streaming helpers of kernels E and F (csrc/vanka.cu, csrc/kaczmarz.cu):
// one warp walks a chain of steps and keeps each step's table record (a
// contiguous, 16-byte padded run of bytes) coming ahead of it into a ring
// in shared memory with the Tensor Memory Accelerator's bulk copy — one
// instruction of one lane a record, its landing reported to the ring
// slot's mbarrier — and gathers the few values at ids the record holds (b
// at the step's rows) with per-lane cp.async.  On the card, a warp's
// cp.async instruction costs tens of ns to issue (a kernel that issued ~7
// a step spent two thirds of its time there), so a step issues at most
// two.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one element of B bytes, global -> shared, asynchronously (cp.async)
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(B)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers: one a ring slot, one arrival (the lane that issues the copy)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) global ->
// shared by the TMA; completion counted on `bar`, which this lane arrives
// on with the byte count.  The fence orders the warp's earlier reads of
// the slot (generic proxy) before the copy's writes (async proxy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) shared -> global by the TMA, waited for
__device__ __forceinline__ void bulk_store_wait(void* dst, const void* src,
                                                uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a ring slot that follows the step: (s + lead) mod N, and the parity of
// its round ((s + lead) / N) & 1, without dividing
template <int N>
struct Slot {
  int v;
  uint32_t phase;
  __device__ explicit Slot(int lead) : v(lead % N), phase((lead / N) & 1) {}
  __device__ __forceinline__ void next() {
    if (++v == N) {
      v = 0;
      phase ^= 1u;
    }
  }
};
