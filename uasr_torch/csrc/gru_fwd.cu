// K5: grouped GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_fwd_kernel (reached
// through pallas_gru_scan -> _fwd), with its save_coeffs outputs.
//
// Inputs, time-major: xp [T, G, B, 3H] input projections (bias added);
// wh [G, H, 3H], bh [G, 3H]; tmask [T, G, B] f32. Output ys [T, G, B, H],
// unmasked. Every group scans forward in frame order (GRULayer reverses
// its own input). Per group and step:
//   hproj = h.to(wh dtype) @ wh[g] + bh[g]          (f32 accumulation)
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h_cand = (1 - z) * n + z * h,  h = mf * h_cand + (1 - mf) * h
// The carry is rounded to the output dtype every step and reread from that
// rounded value, as the TPU kernel does. With save_coeffs (c4 and ch not
// null) the step also writes the backward's linearisation coefficients
// from the same gates (pallas_gru.py:113-130), h = the f32 carry read:
//   c_n2 = mf (1-z)(1-n^2), c4 = (c_n2 hn r(1-r), mf (h-n) z(1-z), c_n2, c_n2 r)
//   in T, ch = (1-mf) + mf z in f32 (it scales the carried gradient, so its
//   rounding would compound over T).
//
// Design: K2's persistent cooperative grid (bigru_fwd.cu) with G groups
// and the batch split over CTA groups. CTA (g, s, c) owns U hidden units
// of group g with all three gate columns, resident in shared memory as f32
// for the whole sequence, and the rows [s * Bs, (s + 1) * Bs) of the batch.
// Each step it stages h_{t-1} of its rows (16-byte loads of the output
// rows the step before wrote, through L2) in tiles of THREADS / U rows;
// thread (row, unit) runs the unit's three length-H dot products and the
// gates and writes h_t. Then the CTAs of (g, s) meet at a barrier of their
// own: rows are independent, so batch splits never wait for each other.
// The unit width U and the split count S are chosen at launch: among the
// widths whose CTAs are all resident, the fewest row tiles per step, then
// the fewest CTAs per split (less of h restaged per step). Zero-length
// rows (mask all 0) keep h at zero.
//
// Bound: a chain of T dependent steps, each a [B, H] x [H, 3H] product
// per group: latency (barrier plus one tile's 3H FMAs per thread on CUDA
// cores), not bytes or FLOPs. Tensor-core products are later work.

#include "grid_sync.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;  // floats of row padding in shared memory

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh, const T* __restrict__ bh,
               const float* __restrict__ tmask, T* ys, T* __restrict__ c4,
               float* __restrict__ ch, unsigned* bar, int Tn, int G, int B, int H, int U,
               int nblk, int S, int Bs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(T);
  const int g = blockIdx.x / (S * nblk);
  const int rem = blockIdx.x - g * S * nblk;
  const int s = rem / nblk;
  const int j0 = (rem - s * nblk) * U;
  const int b_lo = s * Bs, b_hi = min(B, b_lo + Bs);
  const int H3 = 3 * H, HP = H + PAD;
  const int BT = THREADS / U;
  float* w_s = smem;               // [3][U][H + PAD] this CTA's wh columns, f32
  float* h_s = smem + 3 * U * HP;  // [BT][H + PAD] staged h_{t-1}, f32

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
  const size_t group_rows = (size_t)B * H;  // ys elements of one (t, g)
  unsigned* gbar = bar + 2 * LINE * (g * S + s);
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    const T* hsrc = ys + ((size_t)(t > 0 ? t - 1 : 0) * G + g) * group_rows;
    T* hdst = ys + ((size_t)t * G + g) * group_rows;
    const T* xpt = xp + ((size_t)t * G + g) * B * H3;
    const float* mt = tmask + ((size_t)t * G + g) * B;
    for (int b0 = b_lo; b0 < b_hi; b0 += BT) {
      const int nb = min(BT, b_hi - b0);
      const int nvec = H / VEC;
      for (int i = threadIdx.x; i < nb * nvec; i += THREADS) {
        const int r = i / nvec, c = (i - r * nvec) * VEC;
        float v[VEC];
        if (t > 0) {
          load16_l2(hsrc + (size_t)(b0 + r) * H + c, v);
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
        const T* x = xpt + (size_t)b * H3;
        const float xr = to_f32(x[j]), xz = to_f32(x[H + j]), xn = to_f32(x[2 * H + j]);
        const float hr = ar + bias_r, hz = az + bias_z, hn = an + bias_n;
        const float r = 1.f / (1.f + expf(-(xr + hr)));
        const float z = 1.f / (1.f + expf(-(xz + hz)));
        const float n = tanhf(xn + r * hn);
        const float h_prev = h_s[bt * HP + j];
        const float h_cand = (1.f - z) * n + z * h_prev;
        const float mf = mt[b];
        const float h_new = mf * h_cand + (1.f - mf) * h_prev;
        hdst[(size_t)b * H + j] = from_f32<T>(h_new);
        if (c4) {
          const size_t row = ((size_t)t * G + g) * B + b;
          const float c_n2 = mf * ((1.f - z) * (1.f - n * n));
          T* c = c4 + row * 4 * H;
          c[j] = from_f32<T>(c_n2 * (hn * (r * (1.f - r))));
          c[H + j] = from_f32<T>(mf * ((h_prev - n) * (z * (1.f - z))));
          c[2 * H + j] = from_f32<T>(c_n2);
          c[3 * H + j] = from_f32<T>(c_n2 * r);
          ch[row * H + j] = (1.f - mf) + mf * z;
        }
      }
      __syncthreads();
    }
    dir_barrier(gbar, (unsigned)nblk);
  }
}

struct Plan {
  int U, nblk, S, Bs, tiles;
  size_t smem;
};

template <typename T>
cudaError_t launch(const void* xp, const void* wh, const void* bh, const float* tmask, void* ys,
                   void* c4, float* ch, unsigned* bar, int max_groups, int Tn, int G, int B,
                   int H, cudaStream_t stream, int* units, int* splits) {
  int sms = 0, smem_max = 0;
  cudaError_t e = uasr_coop_limits(&sms, &smem_max);
  if (e != cudaSuccess) return e;
  auto kernel = gru_fwd_kernel<T>;
  Plan best{0, 0, 0, 0, 0, 0};
  for (int U = 1; U <= THREADS; U *= 2) {
    const int BT = THREADS / U;
    const size_t smem = (size_t)(3 * U + min(B, BT)) * (H + PAD) * sizeof(float);
    if (smem > (size_t)smem_max) continue;
    e = uasr_set_smem(kernel, smem);
    int occ = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    const int nblk = (H + U - 1) / U;
    const int cap = occ * sms;
    if (G * nblk > cap) continue;
    int S = min(cap / (G * nblk), (B + BT - 1) / BT);
    S = max(1, min(S, max_groups / G));
    const int Bs = (B + S - 1) / S;
    S = (B + Bs - 1) / Bs;  // no empty split
    const int tiles = (Bs + BT - 1) / BT;
    if (best.U == 0 || tiles < best.tiles || (tiles == best.tiles && nblk < best.nblk))
      best = Plan{U, nblk, S, Bs, tiles, smem};
  }
  if (best.U == 0) return cudaErrorCooperativeLaunchTooLarge;
  e = uasr_set_smem(kernel, best.smem);
  if (e != cudaSuccess) return e;
  *units = best.U;
  *splits = best.S;
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wh);
  const T* bb = static_cast<const T*>(bh);
  T* y = static_cast<T*>(ys);
  T* c = static_cast<T*>(c4);
  int U = best.U, nblk = best.nblk, S = best.S, Bs = best.Bs;
  void* args[] = {&x, &w, &bb, &tmask, &y, &c, &ch, &bar, &Tn, &G, &B, &H, &U, &nblk, &S, &Bs};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(G * S * nblk), dim3(THREADS), args,
                                  best.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// xp [T, G, B, 3H], wh [G, H, 3H], bh [G, 3H], ys [T, G, B, H] all of
// `dtype` (UASR_F32 or UASR_BF16); tmask [T, G, B] f32; c4 [T, G, B, 4H]
// of `dtype` and ch [T, G, B, H] f32, both null or both given (save_coeffs);
// bar 2 * 32 * max_groups zeroed uint32 (one barrier per group and split).
// *units and *splits receive the hidden units per CTA and the batch splits
// per group. H must be a multiple of 8 (16-byte rows).
UASR_EXPORT int uasr_gru_fwd(const void* xp, const void* wh, const void* bh, const float* tmask,
                             void* ys, void* c4, float* ch, unsigned* bar, int max_groups, int T,
                             int G, int B, int H, int dtype, void* stream, int device, int* units,
                             int* splits) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || G < 1 || B < 1 || H < 8 || H % 8 || max_groups < G || (!c4) != (!ch))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(xp, wh, bh, tmask, ys, c4, ch, bar, max_groups, T, G, B, H, st, units,
                         splits);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(xp, wh, bh, tmask, ys, c4, ch, bar, max_groups, T, G, B, H, st,
                                 units, splits);
  return cudaErrorInvalidValue;
}
