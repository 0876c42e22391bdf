// The grouped GRU forward recurrence, shared by K5 (gru_fwd.cu, [T, G, B, .]
// rows) and K2 (bigru_fwd.cu, K2's frame-ordered tensors with group 1
// reversed): the kernel and its launch.
//
// Per group g and kernel step t = 0 .. T-1, f = L.frame(t, g), h = 0 first:
//   hproj = h.to(wh dtype) @ wh[g] + bh[g]          (f32 accumulation)
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h_cand = (1 - z) * n + z * h,  h = mf * h_cand + (1 - mf) * h
// with (xr, xz, xn) the row of xp at frame f and mf = tmask[t, g, b]; h is
// written to ys's row at frame f, unmasked. The carry is rounded to the
// output dtype every step and reread from that rounded value, as the TPU
// kernels do. With save_coeffs (c4 and ch not null) the step also writes
// the backward's linearisation coefficients from the same gates
// (pallas_gru.py:113-130), h = the f32 carry read:
//   c_n2 = mf (1-z)(1-n^2), c4 = (c_n2 hn r(1-r), mf (h-n) z(1-z), c_n2, c_n2 r)
//   in T, ch = (1-mf) + mf z in f32 (it scales the carried gradient, so its
//   rounding would compound over T).
// xp and ys are found through a FwdLayout (gru_bwd_chain.cuh); the mask, c4
// and ch are in kernel time [T, G, B, .].
//
// Design: the persistent cooperative grid of the reverse chain
// (gru_bwd_chain.cuh), run forward, with its plan. CTA (g, s, c) owns U
// hidden units of group g, that is the r, z and n columns of wh for them
// (3U columns), and the batch rows [s Bs, (s+1) Bs); the CTAs of (g, s)
// meet at a barrier of their own once a step, so batch splits never wait
// for each other. Each step is one product [Bs, H] x [H, 3U] on the tensor
// cores (mma_sync.cuh: bf16 as stored, f32 as 3xTF32), in passes of R
// rows. A warp computes a tile of 16 MT rows x 8 NT units in each of the
// three gates, so r, z and n of a unit meet in one thread's accumulators,
// as in K5-bwd's coefficient kernel; the 8 warps stand WN along the units,
// WM along the rows and WK along K (a small split, as offline, still keeps
// every warp busy). wh's 3U columns stay resident in shared memory,
// transposed into rows along K at launch (fragments loaded 16 bytes at a
// time, K permuted inside each pair of product steps, from rows padded to
// 16 mod 32 words); where they do not fit (STREAM, chosen by the plan)
// each K chunk of them goes through the ring, as stored (k-major), beside
// the chunk of h rows. The A operand h_{t-1} is ys's row of step t-1: the
// split's rows stream from L2 (cp.async.cg: other CTAs wrote them before
// the barrier) in K chunks of BK elements through a ring of STAGES stages;
// ys's row of step t is the next step's A operand, so nothing else is
// exchanged. The warps' partial tiles meet in shared memory (the ring's
// space) and every thread runs the epilogue for a few (row, unit pair)
// items, adding the WK partials in order (deterministic), with the gates
// of the plain version's expressions; its inputs (xp, the mask and the
// rounded carry h_{t-1}[b, j], through L2) are loaded before the product,
// so their latency hides behind it. At t = 0 the carry is zero and the
// product is skipped (hproj = bh). A pass whose rows are all masked at
// step t skips its loads and product, a warp tile whose rows are all
// masked its product; a masked row's epilogue writes h_{t-1} through
// unchanged (and c4 = 0, ch = 1), which is what the mask gives. Zero-length
// rows keep h = 0. The group's base pointers and each step's frame offset
// are hoisted out of the item loops (as the chain does).
#pragma once

#include "gru_bwd_chain.cuh"
#include "mma_sync.cuh"

namespace gru_bwd {

// The forward's warp tiles: 16 rows x 16 units (MT 1) and 32 x 16 (MT 2),
// each x 3 gates (48 accumulator columns)
constexpr int TILE_MT_FWD[TILES] = {1, 2}, TILE_NT_FWD[TILES] = {2, 2};

// The epilogue's inputs of one row and unit pair, loaded ahead
struct FwdPre {
  float2 xr, xz, xn, hp;
  float mf;
};

template <typename T, int MT, int NT, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
gru_fwd_kernel(const FwdLayout<T> L, const T* __restrict__ wh, const T* __restrict__ bh,
               const float* __restrict__ tmask, T* __restrict__ c4, float* __restrict__ ch,
               unsigned* bar, int Tn, int G, int B, int H, int U, int nblk, int S, int Bs,
               int WM, int BK) {
  using Op = mma::Op<T>;
  constexpr int KP = 2 * Op::K_STEP, VEC = 16 / sizeof(T);  // K of a pair of product steps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Cta c = cta_place(U, nblk, S, Bs, B);
  const int g = c.g, H3 = 3 * H, U3 = 3 * U, KW = k_round<T>(H);
  const int ALD = BK + row_pad<T>(), WLD = KW + row_pad<T>(), BLD = U3 + VEC, PLD = U3 + 8;
  const int PIECES = BK / VEC, NP = U3 / VEC;  // 16-byte pieces of an h chunk row, of 3U columns
  const int WN = U / (8 * NT), WK = WARPS / (WN * WM), R = 16 * MT * WM;
  const int nk = (KW + BK - 1) / BK, items = R * U / 2;
  const int stage = R * ALD + (STREAM ? BK * BLD : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const int wn = warp % WN, wm = (warp / WN) % WM, wk = warp / (WN * WM);
  T* w_s = smem;                                // [3U][WLD] resident: column gate U + u along K
  T* a_s = STREAM ? smem : smem + U3 * WLD;     // STAGES x [R][ALD] h rows (+ [BK][BLD] wh)
  float* part = reinterpret_cast<float*>(a_s);  // [WK][R][PLD] partial tiles
  const T* whg = wh + (size_t)g * H * H3;
  const T* bhg = bh + (size_t)g * H3;
  if (!STREAM) {
    // column n = gate U + u is wh[g][:, gate H + j0 + u]: 16-byte loads along
    // the columns, consecutive threads on consecutive k (conflict-free stores)
    for (int i = threadIdx.x; i < NP * KW; i += THREADS) {
      const int p = i / KW, k = i - p * KW, n = p * VEC, gate = n / U, j = c.j0 + n - gate * U;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < H && j < H)
        v = *reinterpret_cast<const uint4*>(whg + (size_t)k * H3 + gate * H + j);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int x = 0; x < VEC; ++x) w_s[(n + x) * WLD + k] = e[x];
    }
  }
  __syncthreads();
  unsigned* gbar = bar + 2 * LINE * (g * S + c.s);
  // this group's rows of frame 0; ys is written and read back (other CTAs'
  // rows through L2), so it is not restrict-qualified
  const T* __restrict__ xp_g = L.xp.base + g * L.xp.gs;
  T* ys_g = L.ys.base + g * L.ys.gs;
  const int xsb = L.xp.sb, ysb = L.ys.sb;
  for (int t = 0; t < Tn; ++t) {
    const T* hin = ys_g + L.frame(t > 0 ? t - 1 : 0, g, Tn) * L.ys.st;  // h_{t-1}
    T* hout = ys_g + L.frame(t, g, Tn) * L.ys.st;
    const T* __restrict__ xp_t = xp_g + L.frame(t, g, Tn) * L.xp.st;
    const float* mt = tmask + ((size_t)t * G + g) * B;
    for (int r0 = c.b_lo; r0 < c.b_hi; r0 += R) {
      // the epilogue's inputs: item i is row i / (U/2), units 2 (i % (U/2)) + 0, 1
      FwdPre pre[ITEMS];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = threadIdx.x + it * THREADS, r = i / (U / 2);
        const int b = r0 + r, j = c.j0 + 2 * (i - r * (U / 2));
        if (i >= items || b >= c.b_hi || j >= H) continue;  // H even: j + 1 < H too
        const T* x = xp_t + (size_t)b * xsb + j;
        FwdPre& p = pre[it];
        p.mf = mt[b];
        p.xr = mma::ld2(x);
        p.xz = mma::ld2(x + H);
        p.xn = mma::ld2(x + 2 * H);
        p.hp = t > 0 ? mma::ld2_cg(hin + (size_t)b * ysb + j) : make_float2(0.f, 0.f);
      }
      // the product, where the carry is not zero and some row of the pass steps
      bool live = false;
      if (threadIdx.x < R && r0 + (int)threadIdx.x < c.b_hi) live = mt[r0 + threadIdx.x] != 0.f;
      // (the barrier also frees the ring: every thread is past the last pass)
      const bool run = t > 0 && __syncthreads_or(live);
      if (run) {
        bool wl = false;  // does this warp's tile hold a row that steps?
        if (lane < 16 * MT) {
          const int b = r0 + wm * 16 * MT + lane;
          wl = b < c.b_hi && mt[b] != 0.f;
        }
        const bool wlive = __any_sync(0xffffffffu, wl);
        float acc[MT][3][NT][4] = {}, lo[MT][3][NT][4] = {};
        auto load = [&](int kc) {
          if (kc < nk) {
            T* dst = a_s + (kc % STAGES) * stage;
            for (int i = threadIdx.x; i < R * PIECES; i += THREADS) {
              const int r = i / PIECES, kk = (i - r * PIECES) * VEC, k = kc * BK + kk;
              const bool ok = r0 + r < c.b_hi && k < H;
              cp_async16(dst + r * ALD + kk, ok ? hin + (size_t)(r0 + r) * ysb + k : hin, ok);
            }
            if (STREAM) {
              for (int i = threadIdx.x; i < BK * NP; i += THREADS) {
                const int kr = i / NP, n = (i - kr * NP) * VEC, gate = n / U;
                const int j = c.j0 + n - gate * U, k = kc * BK + kr;
                const bool ok = k < H && j < H;
                cp_async16(dst + R * ALD + kr * BLD + n,
                           ok ? whg + (size_t)k * H3 + gate * H + j : whg, ok);
              }
            }
          }
          cp_commit();
        };
        for (int s = 0; s < STAGES - 1; ++s) load(s);
        for (int kc = 0; kc < nk; ++kc) {
          cp_wait<STAGES - 2>();
          __syncthreads();  // chunk kc is in; every warp is past chunk kc - 1
          load(kc + STAGES - 1);
          if (!wlive) continue;
          const T* as = a_s + (kc % STAGES) * stage + wm * 16 * MT * ALD;
          const T* bs = a_s + (kc % STAGES) * stage + R * ALD;
          const int kend = min(BK, KW - kc * BK);
          for (int kk = wk * KP; kk < kend; kk += WK * KP) {
            Op a[MT][2][4];
#pragma unroll
            for (int mt_ = 0; mt_ < MT; ++mt_) mma::load_a2(a[mt_], as + mt_ * 16 * ALD + kk, ALD);
#pragma unroll
            for (int gate = 0; gate < 3; ++gate)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const int n = gate * U + wn * 8 * NT + nt * 8;
                Op b[2][2];
                if (STREAM)
                  mma::load_b2_kn(b, bs + kk * BLD + n, BLD);
                else
                  mma::load_b2(b, w_s + n * WLD + kc * BK + kk, WLD);
#pragma unroll
                for (int s = 0; s < 2; ++s)
#pragma unroll
                  for (int mt_ = 0; mt_ < MT; ++mt_)
                    mma::mma(acc[mt_][gate][nt], lo[mt_][gate][nt], a[mt_][s], b[s]);
              }
          }
        }
        cp_wait<0>();
        __syncthreads();  // the ring is free for the partial tiles
        if (wlive) {
          float* pw = part + ((size_t)wk * R + wm * 16 * MT) * PLD + wn * 8 * NT;
#pragma unroll
          for (int mt_ = 0; mt_ < MT; ++mt_)
#pragma unroll
            for (int gate = 0; gate < 3; ++gate)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  mma::st2(pw + (mt_ * 16 + gq + 8 * h) * PLD + gate * U + nt * 8 + 2 * q,
                           acc[mt_][gate][nt][2 * h] + lo[mt_][gate][nt][2 * h],
                           acc[mt_][gate][nt][2 * h + 1] + lo[mt_][gate][nt][2 * h + 1]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = threadIdx.x + it * THREADS, r = i / (U / 2), u = 2 * (i - r * (U / 2));
        const int b = r0 + r, j = c.j0 + u;
        if (i >= items || b >= c.b_hi || j >= H) continue;
        const FwdPre& p = pre[it];
        const size_t row = ((size_t)t * G + g) * B + b;
        T* y = hout + (size_t)b * ysb + j;
        if (p.mf == 0.f) {  // the mask holds the carry: h_prev through, c4 = 0, ch = 1
          mma::st2(y, p.hp.x, p.hp.y);
          if (c4) {
#pragma unroll
            for (int gate = 0; gate < 4; ++gate)
              mma::st2(c4 + row * 4 * H + gate * H + j, 0.f, 0.f);
            mma::st2(ch + row * H + j, 1.f, 1.f);
          }
          continue;
        }
        float2 hs[3];  // h_{t-1} @ wh for the r, z, n columns of units j, j + 1
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          hs[gate] = make_float2(0.f, 0.f);
          if (run)
            for (int kw = 0; kw < WK; ++kw) {
              const float2 v = mma::ld2(part + ((size_t)kw * R + r) * PLD + gate * U + u);
              hs[gate].x += v.x, hs[gate].y += v.y;
            }
          const float2 bias = mma::ld2(bhg + gate * H + j);
          hs[gate].x += bias.x, hs[gate].y += bias.y;
        }
        auto at = [](float2 v, int e) { return e ? v.y : v.x; };
        float rg[2], zg[2], ng[2], hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hp = at(p.hp, e);
          rg[e] = 1.f / (1.f + expf(-(at(p.xr, e) + at(hs[0], e))));
          zg[e] = 1.f / (1.f + expf(-(at(p.xz, e) + at(hs[1], e))));
          ng[e] = tanhf(at(p.xn, e) + rg[e] * at(hs[2], e));
          const float h_cand = (1.f - zg[e]) * ng[e] + zg[e] * hp;
          hv[e] = p.mf * h_cand + (1.f - p.mf) * hp;
        }
        mma::st2(y, hv[0], hv[1]);
        if (c4) {
          float cv[4][2], chv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float mf = p.mf, c_n2 = mf * ((1.f - zg[e]) * (1.f - ng[e] * ng[e]));
            cv[0][e] = c_n2 * (at(hs[2], e) * (rg[e] * (1.f - rg[e])));
            cv[1][e] = mf * ((at(p.hp, e) - ng[e]) * (zg[e] * (1.f - zg[e])));
            cv[2][e] = c_n2;
            cv[3][e] = c_n2 * rg[e];
            chv[e] = (1.f - mf) + mf * zg[e];
          }
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            mma::st2(c4 + row * 4 * H + gate * H + j, cv[gate][0], cv[gate][1]);
          mma::st2(ch + row * H + j, chv[0], chv[1]);
        }
      }
    }
    dir_barrier(gbar, (unsigned)nblk);
  }
}

// Plan and launch the forward (one cooperative launch). c4 [T, G, B, 4H]
// of T and ch [T, G, B, H] f32, both null or both given (save_coeffs); bar
// 2 * LINE * max_groups zeroed words. *units, *splits: the plan's hidden
// units per CTA and batch splits per group; *streamed: 1 where wh streams
// through the ring.
template <typename T>
cudaError_t launch_fwd(const FwdLayout<T>& L, const T* wh, const T* bh, const float* tmask, T* c4,
                       float* ch, unsigned* bar, int max_groups, int Tn, int G, int B, int H,
                       cudaStream_t stream, int* units, int* splits, int* streamed) {
  using Kernel = decltype(&gru_fwd_kernel<T, 1, 2, false>);
  const Kernel kernels[2][TILES] = {
      {gru_fwd_kernel<T, TILE_MT_FWD[0], TILE_NT_FWD[0], false>,
       gru_fwd_kernel<T, TILE_MT_FWD[1], TILE_NT_FWD[1], false>},
      {gru_fwd_kernel<T, TILE_MT_FWD[0], TILE_NT_FWD[0], true>,
       gru_fwd_kernel<T, TILE_MT_FWD[1], TILE_NT_FWD[1], true>}};
  Plan best;
  cudaError_t e = plan_grid<T>(kernels, TILE_MT_FWD, TILE_NT_FWD, Operands{H, 3, true},
                               max_groups, G, B, H, &best);
  if (e != cudaSuccess) return e;
  *units = best.U;
  *splits = best.S;
  *streamed = best.stream;
  int U = best.U, nblk = best.nblk, S = best.S, Bs = best.Bs, WM = best.WM, BK = best.BK;
  void* args[] = {const_cast<FwdLayout<T>*>(&L), &wh, &bh, &tmask, &c4, &ch, &bar, &Tn, &G,
                  &B, &H, &U, &nblk, &S, &Bs, &WM, &BK};
  e = cudaLaunchCooperativeKernel((const void*)kernels[best.stream][best.tile],
                                  dim3(G * S * nblk), dim3(THREADS), args, best.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace gru_bwd
