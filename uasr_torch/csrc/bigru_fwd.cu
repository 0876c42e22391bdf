// K2: two-stream BiGRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_fwd2_kernel
// (reached through pallas_bigru_scan -> _fwd2), forward only.
//
// Inputs, time-major: p0, p1 [T, B, 3H] input projections (bias added)
// of the forward and the reversed stream, both in frame order;
// wh [2, H, 3H], bh [2, 3H]; tmask [T, 2, B] f32 in kernel time (stream
// 1's first T - len steps are its padding prefix). Output [T, B, 2H] =
// (forward states, reversed states in frame order), unmasked. At kernel
// step u stream 0 reads frame u and stream 1 frame T-1-u. Per stream:
//   hproj = h.to(wh dtype) @ wh[g] + bh[g]          (f32 accumulation)
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h_cand = (1 - z) * n + z * h,  h = mf * h_cand + (1 - mf) * h
// and the carry is rounded to the output dtype every step and reread from
// that rounded value, as the TPU kernel does.
//
// Design: wh is 2 x H x 3H (3 MiB in bf16 at H = 512), more than one SM
// holds, and every step needs all of it. A persistent cooperative grid
// splits it: CTA c owns U hidden units of one direction with all three
// gate columns (U = 8 at B = 32, H = 512: 64 CTAs per direction, its
// 3U wh columns resident in shared memory as f32 for the whole sequence).
// Each step a CTA stages h_{u-1} of its direction (read with 16-byte
// loads from the output rows written the step before, through L2);
// thread (row, unit) runs the unit's three length-H dot products with
// float4 shared-memory reads, applies the gates and writes h_u into the
// output; then the CTAs of that direction meet at a barrier in global
// memory. The two directions never wait for each other.
//
// Bound: the recurrence is a chain of T dependent steps, each a
// [B, H] x [H, 3H] product per direction: latency, not bytes or FLOPs,
// sets the time (the card could do the whole layer's 40 GFLOP in ~0.04
// ms). Per step the cost is the barrier plus one CTA's 3 * H FMAs per
// thread on CUDA cores; tensor-core products are the next step.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;  // floats of row padding in shared memory
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
__device__ void dir_barrier(unsigned* bar, unsigned nblk) {
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
bigru_fwd_kernel(const T* __restrict__ p0, const T* __restrict__ p1,
                 const T* __restrict__ wh, const T* __restrict__ bh,
                 const float* __restrict__ tmask, T* out, unsigned* bar, int Tn,
                 int B, int H, int U, int nblk) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(T);
  const int g = blockIdx.x / nblk;
  const int j0 = (blockIdx.x % nblk) * U;
  const int H3 = 3 * H, HP = H + PAD;
  const int BT = THREADS / U;
  float* w_s = smem;               // [3][U][H + PAD] this CTA's wh columns, f32
  float* h_s = smem + 3 * U * HP;  // [BT][H + PAD] staged h_{u-1}, f32

  const T* whg = wh + (size_t)g * H * H3;
  for (int i = threadIdx.x; i < 3 * U * H; i += THREADS) {
    const int gu = i / H, k = i - gu * H, gate = gu / U, j = j0 + gu - gate * U;
    w_s[gu * HP + k] = j < H ? to_f32(whg[(size_t)k * H3 + gate * H + j]) : 0.f;
  }
  const int uu = threadIdx.x % U, bt = threadIdx.x / U;
  const int j = j0 + uu;
  float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
  if (j < H) {
    bias_r = to_f32(bh[(size_t)g * H3 + j]);
    bias_z = to_f32(bh[(size_t)g * H3 + H + j]);
    bias_n = to_f32(bh[(size_t)g * H3 + 2 * H + j]);
  }
  const float4* wr = reinterpret_cast<const float4*>(w_s + (0 * U + uu) * HP);
  const float4* wz = reinterpret_cast<const float4*>(w_s + (1 * U + uu) * HP);
  const float4* wn = reinterpret_cast<const float4*>(w_s + (2 * U + uu) * HP);
  const T* pg = g == 0 ? p0 : p1;
  const size_t row = 2 * (size_t)H;  // output stride between batch rows
  const size_t frame_stride = (size_t)B * row;
  unsigned* dbar = bar + 2 * LINE * g;
  __syncthreads();

  for (int u = 0; u < Tn; ++u) {
    const int frame = g == 0 ? u : Tn - 1 - u;
    // frame holding h after step u-1 (unused at u = 0, where h = 0)
    const int prev = u == 0 ? frame : (g == 0 ? u - 1 : Tn - u);
    const T* hsrc = out + (size_t)prev * frame_stride + (size_t)g * H;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      const int nvec = H / VEC;
      for (int i = threadIdx.x; i < nb * nvec; i += THREADS) {
        const int r = i / nvec, c = (i - r * nvec) * VEC;
        float v[VEC];
        if (u > 0) {
          load16_l2(hsrc + (size_t)(b0 + r) * row + c, v);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(h_s + r * HP + c + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
      __syncthreads();
      if (bt < nb && j < H) {
        const int b = b0 + bt;
        const float4* h4 = reinterpret_cast<const float4*>(h_s + bt * HP);
        float ar = 0.f, az = 0.f, an = 0.f;
        for (int k = 0; k < H / 4; ++k) {
          const float4 h = h4[k], a = wr[k], z = wz[k], n = wn[k];
          ar = fmaf(h.x, a.x, ar), az = fmaf(h.x, z.x, az), an = fmaf(h.x, n.x, an);
          ar = fmaf(h.y, a.y, ar), az = fmaf(h.y, z.y, az), an = fmaf(h.y, n.y, an);
          ar = fmaf(h.z, a.z, ar), az = fmaf(h.z, z.z, az), an = fmaf(h.z, n.z, an);
          ar = fmaf(h.w, a.w, ar), az = fmaf(h.w, z.w, az), an = fmaf(h.w, n.w, an);
        }
        const T* xp = pg + ((size_t)frame * B + b) * H3;
        const float xr = to_f32(xp[j]), xz = to_f32(xp[H + j]), xn = to_f32(xp[2 * H + j]);
        const float hr = ar + bias_r, hz = az + bias_z, hn = an + bias_n;
        const float r = 1.f / (1.f + expf(-(xr + hr)));
        const float z = 1.f / (1.f + expf(-(xz + hz)));
        const float n = tanhf(xn + r * hn);
        const float h_prev = h_s[bt * HP + j];
        const float h_cand = (1.f - z) * n + z * h_prev;
        const float mf = tmask[((size_t)u * 2 + g) * B + b];
        const float h_new = mf * h_cand + (1.f - mf) * h_prev;
        out[(size_t)frame * frame_stride + (size_t)b * row + (size_t)g * H + j] = from_f32<T>(h_new);
      }
      __syncthreads();
    }
    dir_barrier(dbar, (unsigned)nblk);
  }
}

template <typename T>
cudaError_t launch(const void* p0, const void* p1, const void* wh, const void* bh,
                   const float* tmask, void* out, unsigned* bar, int Tn, int B, int H,
                   cudaStream_t stream, int* units) {
  int dev = 0, sms = 0, smem_max = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  auto kernel = bigru_fwd_kernel<T>;
  // smallest unit slice that still gives every thread a (row, unit) pair
  // and lets both directions' CTAs be resident at once
  int U = 1;
  while (U < THREADS && U * B < THREADS) U *= 2;
  for (; U <= THREADS; U *= 2) {
    int nblk = (H + U - 1) / U;
    const int rows = min(B, THREADS / U);
    const size_t smem = (size_t)(3 * U + rows) * (H + PAD) * sizeof(float);
    if (smem > (size_t)smem_max) continue;
    e = uasr_set_smem(kernel, smem);
    int occ = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (2 * nblk > occ * sms) continue;
    *units = U;
    const T* a0 = static_cast<const T*>(p0);
    const T* a1 = static_cast<const T*>(p1);
    const T* w = static_cast<const T*>(wh);
    const T* bb = static_cast<const T*>(bh);
    T* o = static_cast<T*>(out);
    void* args[] = {&a0, &a1, &w, &bb, &tmask, &o, &bar, &Tn, &B, &H, &U, &nblk};
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * nblk), dim3(THREADS), args,
                                    smem, stream);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// p0, p1 [T, B, 3H], wh [2, H, 3H], bh [2, 3H], out [T, B, 2H] all of
// `dtype` (UASR_F32 or UASR_BF16); tmask [T, 2, B] f32; bar 4 zeroed
// uint32 (4 lines of 32). *units receives the hidden units per CTA.
// H must be a multiple of 8 (16-byte rows).
UASR_EXPORT int uasr_bigru_fwd(const void* p0, const void* p1, const void* wh,
                               const void* bh, const float* tmask, void* out,
                               unsigned* bar, int T, int B, int H, int dtype,
                               void* stream, int device, int* units) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || H < 8 || H % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(p0, p1, wh, bh, tmask, out, bar, T, B, H, s, units);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(p0, p1, wh, bh, tmask, out, bar, T, B, H, s, units);
  return cudaErrorInvalidValue;
}
