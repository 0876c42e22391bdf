// Helpers of the persistent cooperative GRU kernels (gru_fwd_kernel.cuh,
// gru_bwd_chain.cuh): the barrier of the CTAs of one group and batch split,
// and the co-residency limits of a cooperative launch.
#pragma once

#include "common.cuh"

constexpr int LINE = 32;  // uint32 per 128-byte line of the barrier words

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier of the nblk CTAs of one direction (all co-resident: cooperative
// launch). bar[0] counts arrivals, bar[LINE] is the generation, on its own
// line so polling does not slow the arrivals; both start at zero. A wait
// beyond ~10 s traps, so a fault surfaces as a launch error instead of a
// hung card.
__device__ inline void dir_barrier(unsigned* bar, unsigned nblk) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = bar;
    unsigned* gen = bar + LINE;
    const unsigned g = ld_acquire(gen);
    __threadfence();
    if (atomicAdd(count, 1u) == nblk - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      for (unsigned long long spins = 0; ld_acquire(gen) == g; ++spins) {
        if (spins > (1ull << 28)) __trap();
        __nanosleep(32);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Co-residency query of a cooperative launch: SMs, opt-in shared memory
// per block, and whether the device takes cooperative launches at all.
inline cudaError_t uasr_coop_limits(int* sms, int* smem_max) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}
