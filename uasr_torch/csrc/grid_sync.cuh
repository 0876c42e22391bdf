// Helpers of the persistent cooperative GRU kernels (bigru_fwd.cu,
// bigru_bwd.cu): L2 loads of rows other CTAs wrote, and the barrier of
// the CTAs of one direction.
#pragma once

#include "common.cuh"

constexpr int LINE = 32;  // uint32 per 128-byte line of the barrier words

// 16-byte L2 load (past L1, which other SMs' writes do not update) of
// 16 / sizeof(T) consecutive elements, widened to f32
__device__ __forceinline__ void load16_l2(const float* p, float* out) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void load16_l2(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

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
