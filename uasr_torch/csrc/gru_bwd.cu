// K5-bwd: grouped GRU backward (fused: gates recomputed) for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_bwd_kernel (reached
// through pallas_gru_scan's backward rule _bwd_rule -> _bwd_fused, the
// default UASR_GRU_BWD_IMPL=fused).
//
// Inputs, time-major, all of dtype T except the f32 mask: xp [T, G, B, 3H]
// (K5's input), wh [G, H, 3H], bh [G, 3H], tmask [T, G, B], ys
// [T, G, B, H] (K5's output) and its cotangent dy [T, G, B, H]. Outputs:
// dxp [T, G, B, 3H] (d of the input projections, gate order r, z, n) and
// dhn [T, G, B, H] (d of the n block of h_prev @ wh). h_prev at step t is
// ys[t-1] (zero at t = 0), read in the stored dtype.
//
// Phase 1, per step, independent of the carried gradient (:198-219):
//   hp = h_prev @ wh[g] + bh[g] (f32 accumulation); r, z, n as forward
//   c_n2 = mf (1-z)(1-n^2), c_r = c_n2 hn r(1-r), c_z = mf (h_prev-n) z(1-z),
//   c_nh = c_n2 r, ch = (1-mf) + mf z, all f32, into a global scratch
//   (c4 [T, G, B, 4H], ch [T, G, B, H]).
// Phase 2, the reverse chain of gru_bwd_chain.cuh (:221-231).
// A row of length 0 has mask 0 at every step: c4 = 0 and ch = 1, so every
// gradient of the row is 0.
//
// Design: K5's persistent cooperative grid (gru_fwd.cu: G groups, the
// batch split over CTA groups with a barrier each) running K2-bwd's two
// phases (bigru_bwd.cu). Phase 1 stages the 3U wh columns of the CTA's
// units and, for every step and row tile of its split, h_prev, and writes
// the coefficients; the thread that writes a coefficient is the one that
// reads it in phase 2, so no barrier separates the phases.
//
// Bound: phase 1's product and phase 2's per-step products are 2 * steps *
// H * 3H FLOP each over the row-steps the masks keep active (~7 GFLOP each
// at T = 300, B = 64, H = 384 with half the row-steps live), against ~0.3
// GB moved in f32: operations in f32, bytes in bf16. The chain of T
// dependent steps with a barrier each, on CUDA cores, sets the time.
// Tensor-core products are later work.

#include "gru_bwd_chain.cuh"

namespace {

using namespace gru_bwd;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh, const T* __restrict__ bh,
               const float* __restrict__ tmask, const T* __restrict__ ys,
               const T* __restrict__ dy, T* __restrict__ dxp, T* __restrict__ dhn, float* c4,
               float* ch, float* chd, T* xch, unsigned* bar, int Tn, int G, int B, int H, int U,
               int nblk, int S, int Bs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(T);
  const Cta c = cta_place(U, nblk, S, Bs, B);
  const int g = c.g, H3 = 3 * H, HP = H + PAD;
  const int BT = THREADS / U;
  const int uu = threadIdx.x % U, bt = threadIdx.x / U;
  const int j = c.j0 + uu;

  // ---- phase 1: coefficients of every step
  {
    float* w_s = smem;               // [3][U][H + PAD] wh columns of this CTA's units
    float* h_s = smem + 3 * U * HP;  // [BT][H + PAD] staged h_prev, f32
    const T* whg = wh + (size_t)g * H * H3;
    for (int i = threadIdx.x; i < 3 * U * H; i += THREADS) {
      const int gu = i / H, k = i - gu * H, gate = gu / U, jj = c.j0 + gu - gate * U;
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
    const size_t group_rows = (size_t)B * H;  // ys elements of one (t, g)
    __syncthreads();
    for (int t = 0; t < Tn; ++t) {
      const T* hsrc = ys + ((size_t)(t > 0 ? t - 1 : 0) * G + g) * group_rows;
      const T* xpt = xp + ((size_t)t * G + g) * B * H3;
      const float* mt = tmask + ((size_t)t * G + g) * B;
      for (int b0 = c.b_lo; b0 < c.b_hi; b0 += BT) {
        const int nb = min(BT, c.b_hi - b0);
        const int nvec = H / VEC;
        for (int i = threadIdx.x; i < nb * nvec; i += THREADS) {
          const int r = i / nvec, k = (i - r * nvec) * VEC;
          float v[VEC];
          if (t > 0) {
            load16_l2(hsrc + (size_t)(b0 + r) * H + k, v);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(h_s + r * HP + k + e) =
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
          const T* x = xpt + (size_t)b * H3;
          const float xr = to_f32(x[j]), xz = to_f32(x[H + j]), xn = to_f32(x[2 * H + j]);
          const float hn = an + bias_n;
          const float r = 1.f / (1.f + expf(-(xr + (ar + bias_r))));
          const float z = 1.f / (1.f + expf(-(xz + (az + bias_z))));
          const float n = tanhf(xn + r * hn);
          const float h_prev = h_s[bt * HP + j];
          const float mf = mt[b];
          const float c_n2 = mf * ((1.f - z) * (1.f - n * n));
          const size_t row = ((size_t)t * G + g) * B + b;
          float* cc = c4 + row * 4 * H;
          cc[j] = c_n2 * (hn * (r * (1.f - r)));             // c_r
          cc[H + j] = mf * ((h_prev - n) * (z * (1.f - z)));  // c_z
          cc[2 * H + j] = c_n2;                              // c_n2
          cc[3 * H + j] = c_n2 * r;                          // c_nh
          ch[row * H + j] = (1.f - mf) + mf * z;
        }
        __syncthreads();
      }
    }
  }

  // ---- phase 2: the reverse chain (reuses the shared memory)
  reverse_chain<T, float, false>(c4, ch, dy, wh, nullptr, dxp, dhn, chd, xch, bar, Tn, G, B, H,
                                 U, nblk, S, Bs, smem);
}

template <typename T>
cudaError_t launch(const void* xp, const void* wh, const void* bh, const float* tmask,
                   const void* ys, const void* dy, void* dxp, void* dhn, float* c4, float* ch,
                   float* chd, void* xch, unsigned* bar, int max_groups, int Tn, int G, int B,
                   int H, cudaStream_t stream, int* units, int* splits) {
  auto kernel = gru_bwd_kernel<T>;
  auto smem_of = [H](int U, int rows) {
    const size_t p1 = (size_t)(3 * U + rows) * (H + PAD) * sizeof(float);
    const size_t p2 = chain_smem<T>(U, rows, H);
    return p1 > p2 ? p1 : p2;
  };
  Plan best;
  cudaError_t e = plan_grid(kernel, smem_of, max_groups, G, B, H, &best);
  if (e != cudaSuccess) return e;
  *units = best.U;
  *splits = best.S;
  const T *x = static_cast<const T*>(xp), *w = static_cast<const T*>(wh);
  const T *bb = static_cast<const T*>(bh), *y = static_cast<const T*>(ys);
  const T* dyp = static_cast<const T*>(dy);
  T *dx = static_cast<T*>(dxp), *dn = static_cast<T*>(dhn), *xc = static_cast<T*>(xch);
  int U = best.U, nblk = best.nblk, S = best.S, Bs = best.Bs;
  void* args[] = {&x,  &w,   &bb, &tmask, &y, &dyp, &dx,   &dn, &c4, &ch, &chd,
                  &xc, &bar, &Tn, &G,     &B, &H,   &U,    &nblk, &S, &Bs};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(G * S * nblk), dim3(THREADS), args,
                                  best.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// xp, dxp [T, G, B, 3H]; wh [G, H, 3H]; bh [G, 3H]; ys, dy, dhn
// [T, G, B, H]: all of `dtype` (UASR_F32 or UASR_BF16). tmask [T, G, B]
// f32; scratch: c4 [T, G, B, 4H] and ch [T, G, B, H] f32 (phase 1's
// coefficients), chd [G, B, H] f32, xch [2, G, B, 3H] of `dtype`; bar
// 2 * 32 * max_groups zeroed uint32. *units and *splits receive the hidden
// units per CTA and the batch splits per group. H must be a multiple of 8.
UASR_EXPORT int uasr_gru_bwd(const void* xp, const void* wh, const void* bh, const float* tmask,
                             const void* ys, const void* dy, void* dxp, void* dhn, float* c4,
                             float* ch, float* chd, void* xch, unsigned* bar, int max_groups,
                             int T, int G, int B, int H, int dtype, void* stream, int device,
                             int* units, int* splits) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || G < 1 || B < 1 || H < 8 || H % 8 || max_groups < G) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(xp, wh, bh, tmask, ys, dy, dxp, dhn, c4, ch, chd, xch, bar, max_groups,
                         T, G, B, H, st, units, splits);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(xp, wh, bh, tmask, ys, dy, dxp, dhn, c4, ch, chd, xch, bar,
                                 max_groups, T, G, B, H, st, units, splits);
  return cudaErrorInvalidValue;
}
