// K2-bwd: two-stream BiGRU backward for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_bwd2_kernel
// (reached through pallas_bigru_scan's backward rule _bwd2_rule).
//
// Inputs, time-major, all of dtype T except the f32 mask: p0, p1
// [T, B, 3H] (K2's inputs, frame order), wh [2, H, 3H], bh [2, 3H],
// tmask [T, 2, B] in kernel time, out [T, B, 2H] (K2's output) and its
// cotangent dout [T, B, 2H]. Outputs in frame order: dxp0, dxp1
// [T, B, 3H] (d of the input projections, gate order r, z, n) and dhn0,
// dhn1 [T, B, H] (d of the n block of h_prev @ wh). Stream g's kernel
// step u reads frame u (g = 0) or T-1-u (g = 1); h_prev at step u is
// the output row of step u-1 (zero at u = 0), read in the stored dtype.
//
// Phase 1, per step, independent of the carried gradient:
//   hp = h_prev @ wh[g] + bh[g] (f32 accumulation); r, z, n as forward
//   c_n2 = mf (1-z)(1-n^2), c_r = c_n2 hn r(1-r), c_z = mf (h_prev-n) z(1-z),
//   c_nh = c_n2 r, ch = (1-mf) + mf z
// Phase 2, the reverse chain over kernel steps u = T-1 .. 0, dh = 0 first:
//   d = dh + dy[u]; (e_r, e_z, e_n, e_nh) = (c_r, c_z, c_n2, c_nh) * d
//   dxp[u] = (e_r, e_z, e_n), dhn[u] = e_nh, rounded to T
//   dh = ch * d + round_T(e_r, e_z, e_nh) @ wh[g]^T   (f32 accumulation)
// dh is carried in f32. These are the TPU kernel's rounding points.
//
// Design: K2's persistent cooperative grid, run in reverse kernel time.
// CTA c of direction g owns U hidden units j0..j0+U-1.
// - Phase 1 stages the 3U wh columns of its units (as K2 does) and, for
//   every step and batch row, recomputes its units' gates from h_prev and
//   writes the five coefficients to a global scratch [2, T, 5, B, H] f32;
//   the thread that writes a coefficient is the one that reads it in
//   phase 2, so no barrier separates the phases.
// - Phase 2 holds the U rows of wh (wh^T's columns for its units, all 3H
//   wide) in shared memory as f32. dh[b, i] needs all 3H of the previous
//   step's dhproj = (e_r, e_z, e_nh), three times the width K2 exchanges,
//   so each step every CTA writes its units' dhproj (already rounded to
//   T, as the product wants it) into a double-buffered exchange row in
//   global memory, meets the direction's other CTAs at one barrier, and
//   stages all of [B, 3H] from L2 in T (bf16 halves the bytes) before
//   its B x U dot products of length 3H. ch * d stays in shared memory
//   for the next step.
//
// Bound: phase 1's product and phase 2's per-step products are
// 2 * T * 2 * B * H * 3H FLOP each (~80 GFLOP in all at T = 400, B = 32,
// H = 512; ~0.08 ms at bf16 tensor-core peak), and ~240 MB move; the
// chain of T dependent steps with a grid barrier each, on CUDA cores,
// sets the time.

#include "grid_sync.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;  // floats of row padding of the f32 rows in shared memory
constexpr int NCOEF = 5;

// 8 consecutive elements of a shared-memory row (16- or 32-byte aligned)
__device__ __forceinline__ void load8_smem(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
__device__ __forceinline__ void load8_smem(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void copy16_l2(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldcg(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ void copy16_l2(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldcg(reinterpret_cast<const uint4*>(src));
}

template <typename T>
__host__ __device__ constexpr int xpad() {
  return 16 / sizeof(T);  // elements of row padding of the staged exchange rows
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bigru_bwd_kernel(const T* __restrict__ p0, const T* __restrict__ p1,
                 const T* __restrict__ wh, const T* __restrict__ bh,
                 const float* __restrict__ tmask, const T* __restrict__ out,
                 const T* __restrict__ dout, T* __restrict__ dxp0, T* __restrict__ dxp1,
                 T* __restrict__ dhn0, T* __restrict__ dhn1, float* coef, T* xch,
                 unsigned* bar, int Tn, int B, int H, int U, int nblk, size_t region) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(T);
  const int g = blockIdx.x / nblk;
  const int j0 = (blockIdx.x % nblk) * U;
  const int H3 = 3 * H, HP = H + PAD, H3P = H3 + PAD, XP = H3 + xpad<T>();
  const int BT = THREADS / U;
  const int uu = threadIdx.x % U, bt = threadIdx.x / U;
  const int j = j0 + uu;
  const T* pg = g == 0 ? p0 : p1;
  T* dxp = g == 0 ? dxp0 : dxp1;
  T* dhn = g == 0 ? dhn0 : dhn1;
  const T* whg = wh + (size_t)g * H * H3;
  const size_t row2 = 2 * (size_t)H;  // stride between batch rows of out / dout
  const size_t bh_ = (size_t)B * H;
  float* cg = coef + (size_t)g * Tn * NCOEF * bh_;
  float* chd_s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + region);  // [B][U]

  // ---- phase 1: coefficients of every step
  {
    float* w_s = smem;               // [3][U][H + PAD] wh columns of this CTA's units
    float* h_s = smem + 3 * U * HP;  // [BT][H + PAD] staged h_prev, f32
    for (int i = threadIdx.x; i < 3 * U * H; i += THREADS) {
      const int gu = i / H, k = i - gu * H, gate = gu / U, jj = j0 + gu - gate * U;
      w_s[gu * HP + k] = jj < H ? to_f32(whg[(size_t)k * H3 + gate * H + jj]) : 0.f;
    }
    float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
    if (j < H) {
      bias_r = to_f32(bh[(size_t)g * H3 + j]);
      bias_z = to_f32(bh[(size_t)g * H3 + H + j]);
      bias_n = to_f32(bh[(size_t)g * H3 + 2 * H + j]);
    }
    const float4* wr = reinterpret_cast<const float4*>(w_s + (0 * U + uu) * HP);
    const float4* wz = reinterpret_cast<const float4*>(w_s + (1 * U + uu) * HP);
    const float4* wn = reinterpret_cast<const float4*>(w_s + (2 * U + uu) * HP);
    __syncthreads();
    for (int u = 0; u < Tn; ++u) {
      const int frame = g == 0 ? u : Tn - 1 - u;
      // frame holding h_prev (unused at u = 0, where h_prev = 0)
      const int prev = u == 0 ? frame : (g == 0 ? u - 1 : Tn - u);
      const T* hsrc = out + (size_t)prev * B * row2 + (size_t)g * H;
      for (int b0 = 0; b0 < B; b0 += BT) {
        const int nb = min(BT, B - b0);
        const int nvec = H / VEC;
        for (int i = threadIdx.x; i < nb * nvec; i += THREADS) {
          const int r = i / nvec, c = (i - r * nvec) * VEC;
          float v[VEC];
          if (u > 0) {
            load16_l2(hsrc + (size_t)(b0 + r) * row2 + c, v);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(h_s + r * HP + c + e) =
                make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
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
          const float hn = an + bias_n;
          const float r = 1.f / (1.f + expf(-(xr + (ar + bias_r))));
          const float z = 1.f / (1.f + expf(-(xz + (az + bias_z))));
          const float n = tanhf(xn + r * hn);
          const float h_prev = h_s[bt * HP + j];
          const float mf = tmask[((size_t)u * 2 + g) * B + b];
          const float c_n2 = mf * ((1.f - z) * (1.f - n * n));
          float* c = cg + (size_t)u * NCOEF * bh_ + (size_t)b * H + j;
          c[0 * bh_] = c_n2 * (hn * (r * (1.f - r)));      // c_r
          c[1 * bh_] = mf * ((h_prev - n) * (z * (1.f - z)));  // c_z
          c[2 * bh_] = c_n2;                              // c_n2
          c[3 * bh_] = c_n2 * r;                          // c_nh
          c[4 * bh_] = (1.f - mf) + mf * z;               // ch
        }
        __syncthreads();
      }
    }
  }

  // ---- phase 2: the reverse chain
  float* wt_s = smem;  // [U][3H + PAD] wh rows of this CTA's units, f32
  T* x_s = reinterpret_cast<T*>(smem + U * H3P);  // [BT][3H + xpad] staged dhproj
  for (int i = threadIdx.x; i < U * H3; i += THREADS) {
    const int r = i / H3, k = i - r * H3;
    wt_s[r * H3P + k] = j0 + r < H ? to_f32(whg[(size_t)(j0 + r) * H3 + k]) : 0.f;
  }
  __syncthreads();
  const float* wrow = wt_s + uu * H3P;
  unsigned* dbar = bar + 2 * LINE * g;
  T* xg = xch + (size_t)g * 2 * B * H3;  // [2][B][3H] exchange rows of this direction
  for (int step = 0; step < Tn; ++step) {
    const int u = Tn - 1 - step;
    const int frame = g == 0 ? u : Tn - 1 - u;
    const T* xin = xg + (size_t)((u + 1) & 1) * B * H3;  // dhproj of step u + 1
    T* xout = xg + (size_t)(u & 1) * B * H3;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      if (step > 0) {
        const int nvec = H3 / VEC;
        for (int i = threadIdx.x; i < nb * nvec; i += THREADS) {
          const int r = i / nvec, c = (i - r * nvec) * VEC;
          copy16_l2(xin + (size_t)(b0 + r) * H3 + c, x_s + r * XP + c);
        }
        __syncthreads();
      }
      if (bt < nb && j < H) {
        const int b = b0 + bt;
        float dh = 0.f;
        if (step > 0) {
          const T* xr = x_s + bt * XP;
          float acc = 0.f;
          for (int k = 0; k < H3; k += 8) {
            float x[8], w[8];
            load8_smem(xr + k, x);
            load8_smem(wrow + k, w);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc = fmaf(x[e], w[e], acc);
          }
          dh = chd_s[b * U + uu] + acc;
        }
        const float d = dh + to_f32(dout[((size_t)frame * B + b) * row2 + (size_t)g * H + j]);
        const float* c = cg + (size_t)u * NCOEF * bh_ + (size_t)b * H + j;
        const float e_r = c[0 * bh_] * d, e_z = c[1 * bh_] * d;
        const float e_n = c[2 * bh_] * d, e_nh = c[3 * bh_] * d;
        T* dx = dxp + ((size_t)frame * B + b) * H3;
        dx[j] = from_f32<T>(e_r);
        dx[H + j] = from_f32<T>(e_z);
        dx[2 * H + j] = from_f32<T>(e_n);
        dhn[((size_t)frame * B + b) * H + j] = from_f32<T>(e_nh);
        T* xo = xout + (size_t)b * H3;
        xo[j] = from_f32<T>(e_r);
        xo[H + j] = from_f32<T>(e_z);
        xo[2 * H + j] = from_f32<T>(e_nh);
        chd_s[b * U + uu] = c[4 * bh_] * d;
      }
      __syncthreads();
    }
    dir_barrier(dbar, (unsigned)nblk);
  }
}

// shared memory of the larger phase, then B x U floats of ch * d
template <typename T>
void smem_layout(int U, int B, int H, size_t* region, size_t* total) {
  const int rows = min(B, THREADS / U);
  const size_t p1 = (size_t)(3 * U + rows) * (H + PAD) * sizeof(float);
  const size_t p2 = (size_t)U * (3 * H + PAD) * sizeof(float) +
                    (size_t)rows * (3 * H + xpad<T>()) * sizeof(T);
  *region = p1 > p2 ? p1 : p2;
  *total = *region + (size_t)B * U * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* p0, const void* p1, const void* wh, const void* bh,
                   const float* tmask, const void* out, const void* dout, void* dxp0,
                   void* dxp1, void* dhn0, void* dhn1, float* coef, void* xch, unsigned* bar,
                   int Tn, int B, int H, cudaStream_t stream, int* units) {
  int sms = 0, smem_max = 0;
  cudaError_t e = uasr_coop_limits(&sms, &smem_max);
  if (e != cudaSuccess) return e;
  auto kernel = bigru_bwd_kernel<T>;
  int U = 1;
  while (U < THREADS && U * B < THREADS) U *= 2;
  for (; U <= THREADS; U *= 2) {
    int nblk = (H + U - 1) / U;
    size_t region = 0, smem = 0;
    smem_layout<T>(U, B, H, &region, &smem);
    if (smem > (size_t)smem_max) continue;
    e = uasr_set_smem(kernel, smem);
    int occ = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (2 * nblk > occ * sms) continue;
    *units = U;
    const T *a0 = static_cast<const T*>(p0), *a1 = static_cast<const T*>(p1);
    const T *w = static_cast<const T*>(wh), *bb = static_cast<const T*>(bh);
    const T *o = static_cast<const T*>(out), *dy = static_cast<const T*>(dout);
    T *d0 = static_cast<T*>(dxp0), *d1 = static_cast<T*>(dxp1);
    T *n0 = static_cast<T*>(dhn0), *n1 = static_cast<T*>(dhn1);
    T* x = static_cast<T*>(xch);
    void* args[] = {&a0, &a1, &w, &bb, &tmask, &o, &dy, &d0, &d1, &n0, &n1, &coef, &x,
                    &bar, &Tn, &B, &H, &U, &nblk, &region};
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * nblk), dim3(THREADS), args,
                                    smem, stream);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// p0, p1, dxp0, dxp1 [T, B, 3H]; wh [2, H, 3H]; bh [2, 3H]; out, dout
// [T, B, 2H]; dhn0, dhn1 [T, B, H]: all of `dtype` (UASR_F32 or
// UASR_BF16). tmask [T, 2, B] f32; coef scratch [2, T, 5, B, H] f32; xch
// scratch [2, 2, B, 3H] of `dtype`; bar 4 lines of 32 zeroed uint32.
// *units receives the hidden units per CTA. H must be a multiple of 8.
UASR_EXPORT int uasr_bigru_bwd(const void* p0, const void* p1, const void* wh,
                               const void* bh, const float* tmask, const void* out,
                               const void* dout, void* dxp0, void* dxp1, void* dhn0,
                               void* dhn1, float* coef, void* xch, unsigned* bar, int T,
                               int B, int H, int dtype, void* stream, int device, int* units) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || H < 8 || H % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(p0, p1, wh, bh, tmask, out, dout, dxp0, dxp1, dhn0, dhn1, coef, xch,
                         bar, T, B, H, s, units);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(p0, p1, wh, bh, tmask, out, dout, dxp0, dxp1, dhn0, dhn1,
                                 coef, xch, bar, T, B, H, s, units);
  return cudaErrorInvalidValue;
}
