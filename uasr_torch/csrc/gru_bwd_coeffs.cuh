// The coefficient kernel of the fused GRU backward, shared by K5-bwd
// (gru_bwd.cu) and K2-bwd (bigru_bwd.cu): what the TPU kernels' first
// phase does per step (pallas_gru.py:198-219 and :591-612), for every step
// at once, since none of it depends on the carried gradient:
//   hp = h_prev @ wh[g] + bh[g] (f32 accumulation); r, z, n as forward
//   c_n2 = mf (1-z)(1-n^2), c_r = c_n2 hn r(1-r), c_z = mf (h_prev-n) z(1-z),
//   c_nh = c_n2 r, ch = (1-mf) + mf z, all f32, into c4 [T, G, B, 4H] and
//   ch [T, G, B, H] in kernel time,
// reading xp and h_prev (the row of ys at step t-1, zero at t = 0, in the
// stored dtype) through the Layout of gru_bwd_chain.cuh. The mask tmask
// [T, G, B] is in kernel time. A row of length 0 has mask 0 at every step:
// c4 = 0 and ch = 1, so every gradient of the row is 0.
//
// Design: one tall product [T B, H] x [H, 3H] per group on the tensor cores
// (mma_sync.cuh: bf16 as stored, f32 as 3xTF32), tiled so the epilogue
// holds all three gates of a unit: a CTA takes 128 (t, b) rows and 32
// hidden units, the [128 x 96] tile of their r, z and n columns over K = H,
// with K chunks of h_prev and wh staged through a two-stage cp.async ring;
// 8 warps of 32 rows x 16 units. The epilogue adds the bias and computes
// the gates and coefficients with the expressions of the plain version. A
// tile whose rows are all masked writes c4 = 0 and ch = 1 without the
// product.
#pragma once

#include "gru_bwd_chain.cuh"

namespace gru_bwd {

namespace coef {
constexpr int THREADS = 256;  // 8 warps: 4 along the rows x 2 along the units
constexpr int ROWS = 128;     // (t, b) rows of a tile
constexpr int UNITS = 32;     // hidden units of a tile: 96 columns of wh (r, z, n)
constexpr int CHUNK = 128;    // bytes of an h_prev row per K chunk
constexpr int STAGES = 2;     // depth of the cp.async ring (3, or 256-byte chunks: slower)
constexpr int B_LD = 3 * UNITS + 8;  // wh chunk row pitch (elements)
template <typename T>
__host__ __device__ constexpr int bk() {
  return CHUNK / sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int a_ld() {
  return bk<T>() + 16 / sizeof(T);  // h_prev chunk row pitch (elements)
}
template <typename T>
__host__ __device__ constexpr int stage() {
  return ROWS * a_ld<T>() + bk<T>() * B_LD;  // elements of one ring stage
}
}  // namespace coef

template <typename T>
__global__ void __launch_bounds__(coef::THREADS, 2)
coeffs_kernel(const Layout<T> L, const T* __restrict__ wh, const T* __restrict__ bh,
              const float* __restrict__ tmask, float* __restrict__ c4, float* __restrict__ ch,
              int Tn, int G, int B, int H) {
  using Op = mma::Op<T>;
  constexpr int KS = Op::K_STEP, BK = coef::bk<T>(), ALD = coef::a_ld<T>(), VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int TB = Tn * B, H3 = 3 * H, grp = blockIdx.z;
  const int m0 = blockIdx.x * coef::ROWS, j0 = blockIdx.y * coef::UNITS;
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int wm = warp >> 1, wn = warp & 1;

  // a tile of masked rows only: c4 = 0, ch = 1, as the product path gives
  bool live = false;
  if (threadIdx.x < coef::ROWS && m0 + threadIdx.x < TB) {
    const int m = m0 + threadIdx.x, t = m / B;
    live = tmask[((size_t)t * G + grp) * B + (m - t * B)] != 0.f;
  }
  if (!__syncthreads_or(live)) {
    for (int i = threadIdx.x; i < coef::ROWS * coef::UNITS; i += coef::THREADS) {
      const int r = i / coef::UNITS, j = j0 + i - r * coef::UNITS, m = m0 + r;
      if (m >= TB || j >= H) continue;
      const int t = m / B;
      const size_t row = ((size_t)t * G + grp) * B + (m - t * B);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) c4[row * 4 * H + gate * H + j] = 0.f;
      ch[row * H + j] = 1.f;
    }
    return;
  }

  const T* whg = wh + (size_t)grp * H * H3;
  const T* ys_g = L.ys.base + grp * L.ys.gs;  // this group's rows of frame 0
  const int nk = (H + BK - 1) / BK;
  auto load = [&](int kc) {
    if (kc >= nk) {
      cp_commit();
      return;
    }
    T* a_s = smem + (kc % coef::STAGES) * coef::stage<T>();
    T* b_s = a_s + coef::ROWS * ALD;
    const int k0 = kc * BK;
    constexpr int AP = coef::CHUNK / 16;  // 16-byte pieces of a row chunk
    for (int i = threadIdx.x; i < coef::ROWS * AP; i += coef::THREADS) {
      const int r = i / AP, kk = (i - r * AP) * VEC, m = m0 + r, t = m / B;
      const bool ok = m < TB && t > 0 && k0 + kk < H;
      const T* src = ok ? ys_g + L.frame(t - 1, grp, Tn) * L.ys.st + (size_t)(m - t * B) * L.ys.sb
                              + k0 + kk
                        : whg;
      cp_async16(a_s + r * ALD + kk, src, ok);
    }
    constexpr int BP = coef::UNITS * sizeof(T) / 16;  // pieces of one gate's units in a wh row
    for (int i = threadIdx.x; i < BK * 3 * BP; i += coef::THREADS) {
      const int kr = i / (3 * BP), rem = i - kr * 3 * BP, gate = rem / BP;
      const int u = (rem - gate * BP) * VEC, k = k0 + kr, j = j0 + u;
      const bool ok = k < H && j < H;
      cp_async16(b_s + kr * coef::B_LD + gate * coef::UNITS + u,
                 ok ? whg + (size_t)k * H3 + gate * H + j : whg, ok);
    }
    cp_commit();
  };

  float acc[2][3][2][4] = {};  // [row block][gate][unit block][fragment]
  for (int s = 0; s < coef::STAGES - 1; ++s) load(s);
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<coef::STAGES - 2>();
    __syncthreads();  // chunk kc is in; every warp is past chunk kc - 1
    load(kc + coef::STAGES - 1);
    const T* a_s = smem + (kc % coef::STAGES) * coef::stage<T>() + wm * 32 * ALD;
    const T* b_s = smem + (kc % coef::STAGES) * coef::stage<T>() + coef::ROWS * ALD + wn * 16;
#pragma unroll
    for (int kk = 0; kk < BK; kk += KS) {
      Op a[2][4];
      mma::load_a(a[0], a_s + kk, ALD);
      mma::load_a(a[1], a_s + 16 * ALD + kk, ALD);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          Op b[2];
          mma::load_b_kn(b, b_s + kk * coef::B_LD + gate * coef::UNITS + nt * 8, coef::B_LD);
          mma::mma(acc[0][gate][nt], acc[0][gate][nt], a[0], b);
          mma::mma(acc[1][gate][nt], acc[1][gate][nt], a[1], b);
        }
      }
    }
  }

  // epilogue: rows wm*32 + mi*16 + gq (+8), units wn*16 + nt*8 + 2q (+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mi * 16 + gq + 8 * h;
      if (m >= TB) continue;
      const int t = m / B, b = m - t * B;
      const size_t row = ((size_t)t * G + grp) * B + b;
      const float mf = tmask[row];
      const T* x = L.xp.at(L.frame(t, grp, Tn), grp, b);
      const T* hrow = L.ys.at(L.frame(t > 0 ? t - 1 : 0, grp, Tn), grp, b);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = j0 + wn * 16 + nt * 8 + 2 * q;
        if (j >= H) continue;  // H even: j + 1 < H too
        const float2 xr = mma::ld2(x + j), xz = mma::ld2(x + H + j), xn = mma::ld2(x + 2 * H + j);
        const float2 br = mma::ld2(bh + (size_t)grp * H3 + j);
        const float2 bz = mma::ld2(bh + (size_t)grp * H3 + H + j);
        const float2 bn = mma::ld2(bh + (size_t)grp * H3 + 2 * H + j);
        const float2 hp2 = t > 0 ? mma::ld2(hrow + j) : make_float2(0.f, 0.f);
        float out[4][2], chv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ar = acc[mi][0][nt][2 * h + e], az = acc[mi][1][nt][2 * h + e];
          const float an = acc[mi][2][nt][2 * h + e];
          const float hn = an + (e ? bn.y : bn.x);
          const float r = 1.f / (1.f + expf(-((e ? xr.y : xr.x) + (ar + (e ? br.y : br.x)))));
          const float z = 1.f / (1.f + expf(-((e ? xz.y : xz.x) + (az + (e ? bz.y : bz.x)))));
          const float n = tanhf((e ? xn.y : xn.x) + r * hn);
          const float h_prev = e ? hp2.y : hp2.x;
          const float c_n2 = mf * ((1.f - z) * (1.f - n * n));
          out[0][e] = c_n2 * (hn * (r * (1.f - r)));             // c_r
          out[1][e] = mf * ((h_prev - n) * (z * (1.f - z)));     // c_z
          out[2][e] = c_n2;                                      // c_n2
          out[3][e] = c_n2 * r;                                  // c_nh
          chv[e] = (1.f - mf) + mf * z;
        }
        float* cc = c4 + row * 4 * H + j;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) mma::st2(cc + gate * H, out[gate][0], out[gate][1]);
        mma::st2(ch + row * H + j, chv[0], chv[1]);
      }
    }
  }
}

// Launch the coefficient kernel: a grid of 128-row tiles x 32-unit tiles
// x G groups.
template <typename T>
cudaError_t launch_coeffs(const Layout<T>& L, const T* wh, const T* bh, const float* tmask,
                          float* c4, float* ch, int Tn, int G, int B, int H,
                          cudaStream_t stream) {
  auto kernel = coeffs_kernel<T>;
  const size_t smem = coef::STAGES * coef::stage<T>() * sizeof(T);
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const long tiles = ((long)Tn * B + coef::ROWS - 1) / coef::ROWS;
  if (tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (H + coef::UNITS - 1) / coef::UNITS, G);
  kernel<<<grid, coef::THREADS, smem, stream>>>(L, wh, bh, tmask, c4, ch, Tn, G, B, H);
  return cudaGetLastError();
}

}  // namespace gru_bwd
