// The reverse chain of the grouped GRU backward, shared by K5-bwd
// (gru_bwd.cu, its phase 2) and K8 (gru_bwd_lin.cu, the whole kernel), and
// the launch plan of both.
//
// Per group g and step t = T-1 .. 0, dh = 0 first, dh carried in f32:
//   d = dh + dy[t]
//   (e_r, e_z, e_n, e_nh) = (c_r, c_z, c_n2, c_nh)[t] * d
//   stored rounded to T: (e_r, e_z, e_n) and e_nh (K5-bwd: dxp and dhn;
//   K8: one [.., 4H] row)
//   dh = ch[t] * d + round_T(e_r, e_z, e_nh) @ wh[g]^T    (f32 accumulation)
// These are the TPU kernels' rounding points (pallas_gru.py:221-231 and
// :156-169). The coefficients c4 [T, G, B, 4H] are f32 (K5-bwd's phase 1)
// or T (the forward's save_coeffs output, K8); ch [T, G, B, H] is f32.
//
// Grid: K5's persistent cooperative grid. CTA (g, s, c) owns hidden units
// j0 .. j0+U-1 of group g and the batch rows [s Bs, (s+1) Bs). It holds the
// U rows of wh[g] (the columns of wh^T for its units, all 3H wide) in
// shared memory as f32. dh[b, j] needs all 3H of the step before's dhproj,
// so each step every CTA writes its units' dhproj (rounded to T, as the
// product wants it) into a double-buffered exchange row in global memory,
// meets the other CTAs of (g, s) at their barrier, and stages the split's
// rows of [B, 3H] from L2 before its dot products of length 3H. ch * d,
// which the same thread needs at the next step, stays in a global f32
// scratch [G, B, H]; thread (row tile, unit) reads the coefficients that
// it (or the forward) wrote for the same (t, b, j). c4 and ch are read by
// plain loads (no __restrict__, so never through the non-coherent cache):
// K5-bwd writes them in the same launch.
#pragma once

#include "grid_sync.cuh"

namespace gru_bwd {

constexpr int THREADS = 256;
constexpr int PAD = 4;  // floats of row padding of the f32 rows in shared memory

template <typename T>
__host__ __device__ constexpr int xpad() {
  return 16 / sizeof(T);  // elements of row padding of the staged exchange rows
}

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

// This CTA's place in the grid: group, batch split, first unit, its rows.
struct Cta {
  int g, s, j0, b_lo, b_hi;
};

__device__ __forceinline__ Cta cta_place(int U, int nblk, int S, int Bs, int B) {
  Cta c;
  c.g = blockIdx.x / (S * nblk);
  const int rem = blockIdx.x - c.g * S * nblk;
  c.s = rem / nblk;
  c.j0 = (rem - c.s * nblk) * U;
  c.b_lo = c.s * Bs;
  c.b_hi = min(B, c.b_lo + Bs);
  return c;
}

// Shared memory of the chain: U rows of wh as f32, `rows` staged rows of
// dhproj in T.
template <typename T>
__host__ __device__ inline size_t chain_smem(int U, int rows, int H) {
  return (size_t)U * (3 * H + PAD) * sizeof(float) + (size_t)rows * (3 * H + xpad<T>()) * sizeof(T);
}

// The reverse chain. LIN: out4 [T, G, B, 4H] gets all four blocks (K8);
// else dxp [T, G, B, 3H] and dhn [T, G, B, H] (K5-bwd).
template <typename T, typename C, bool LIN>
__device__ void reverse_chain(const C* c4, const float* ch,
                              const T* __restrict__ dy, const T* __restrict__ wh, T* out4,
                              T* dxp, T* dhn, float* chd, T* xch, unsigned* bar, int Tn, int G,
                              int B, int H, int U, int nblk, int S, int Bs, float* smem) {
  constexpr int VEC = 16 / sizeof(T);
  const Cta c = cta_place(U, nblk, S, Bs, B);
  const int g = c.g, H3 = 3 * H, H3P = H3 + PAD, XP = H3 + xpad<T>();
  const int BT = THREADS / U;
  const int uu = threadIdx.x % U, bt = threadIdx.x / U;
  const int j = c.j0 + uu;
  float* wt_s = smem;                             // [U][3H + PAD] wh rows of the units
  T* x_s = reinterpret_cast<T*>(smem + U * H3P);  // [BT][3H + xpad] staged dhproj
  const T* whg = wh + (size_t)g * H * H3;
  for (int i = threadIdx.x; i < U * H3; i += THREADS) {
    const int r = i / H3, k = i - r * H3;
    wt_s[r * H3P + k] = c.j0 + r < H ? to_f32(whg[(size_t)(c.j0 + r) * H3 + k]) : 0.f;
  }
  __syncthreads();
  const float* wrow = wt_s + uu * H3P;
  unsigned* gbar = bar + 2 * LINE * (g * S + c.s);
  for (int step = 0; step < Tn; ++step) {
    const int t = Tn - 1 - step;
    const T* xin = xch + ((size_t)((t + 1) & 1) * G + g) * B * H3;  // dhproj of step t + 1
    T* xout = xch + ((size_t)(t & 1) * G + g) * B * H3;
    for (int b0 = c.b_lo; b0 < c.b_hi; b0 += BT) {
      const int nb = min(BT, c.b_hi - b0);
      if (step > 0) {
        const int nvec = H3 / VEC;
        for (int i = threadIdx.x; i < nb * nvec; i += THREADS) {
          const int r = i / nvec, k = (i - r * nvec) * VEC;
          copy16_l2(xin + (size_t)(b0 + r) * H3 + k, x_s + r * XP + k);
        }
        __syncthreads();
      }
      if (bt < nb && j < H) {
        const int b = b0 + bt;
        const size_t row = ((size_t)t * G + g) * B + b;
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
          dh = chd[((size_t)g * B + b) * H + j] + acc;
        }
        const float d = dh + to_f32(dy[row * H + j]);
        const C* cc = c4 + row * 4 * H;
        const float e_r = to_f32(cc[j]) * d, e_z = to_f32(cc[H + j]) * d;
        const float e_n = to_f32(cc[2 * H + j]) * d, e_nh = to_f32(cc[3 * H + j]) * d;
        if (LIN) {
          T* o = out4 + row * 4 * H;
          o[j] = from_f32<T>(e_r);
          o[H + j] = from_f32<T>(e_z);
          o[2 * H + j] = from_f32<T>(e_n);
          o[3 * H + j] = from_f32<T>(e_nh);
        } else {
          T* dx = dxp + row * H3;
          dx[j] = from_f32<T>(e_r);
          dx[H + j] = from_f32<T>(e_z);
          dx[2 * H + j] = from_f32<T>(e_n);
          dhn[row * H + j] = from_f32<T>(e_nh);
        }
        T* xo = xout + (size_t)b * H3;
        xo[j] = from_f32<T>(e_r);
        xo[H + j] = from_f32<T>(e_z);
        xo[2 * H + j] = from_f32<T>(e_nh);
        chd[((size_t)g * B + b) * H + j] = ch[row * H + j] * d;
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

// The launch plan of a cooperative grid over G groups, `nblk` CTAs of U
// units per batch split: among the unit widths whose CTAs are all
// resident (smem_of(U, rows) bytes each), the fewest row tiles per step,
// then the fewest CTAs per split (less of dhproj restaged per step).
template <typename K, typename F>
cudaError_t plan_grid(K kernel, F smem_of, int max_groups, int G, int B, int H, Plan* best) {
  int sms = 0, smem_max = 0;
  cudaError_t e = uasr_coop_limits(&sms, &smem_max);
  if (e != cudaSuccess) return e;
  *best = Plan{0, 0, 0, 0, 0, 0};
  for (int U = 1; U <= THREADS; U *= 2) {
    const int BT = THREADS / U;
    const size_t smem = smem_of(U, min(B, BT));
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
    if (best->U == 0 || tiles < best->tiles || (tiles == best->tiles && nblk < best->nblk))
      *best = Plan{U, nblk, S, Bs, tiles, smem};
  }
  if (best->U == 0) return cudaErrorCooperativeLaunchTooLarge;
  return uasr_set_smem(kernel, best->smem);
}

}  // namespace gru_bwd
