// The reverse chain of the grouped GRU backward, shared by K5-bwd
// (gru_bwd.cu), K2-bwd (bigru_bwd.cu), both after the coefficient kernel
// of gru_bwd_coeffs.cuh, and K8 (gru_bwd_lin.cu); the row layouts all of
// them and the forward address; and the launch plan of these and of the
// forward (gru_fwd_kernel.cuh: K5 and K2), whose grid is the same.
//
// Per group g and step t = T-1 .. 0, dh = 0 first, dh carried in f32:
//   d = dh + dy[t]
//   (e_r, e_z, e_n, e_nh) = (c_r, c_z, c_n2, c_nh)[t] * d
//   stored rounded to T: dxp[t] = (e_r, e_z, e_n), dhn[t] = e_nh (K8:
//   one [.., 4H] row, addressed as dxp = its first 3H, dhn = its last H)
//   dh = ch[t] * d + round_T(e_r, e_z, e_nh) @ wh[g]^T    (f32 accumulation)
// These are the TPU kernels' rounding points (pallas_gru.py:221-231,
// :614-636 and :156-169). The coefficients c4 [T, G, B, 4H] are f32 (the
// coefficient kernel) or T (the forward's save_coeffs output, K8); ch
// [T, G, B, H] is f32. Both were written by an earlier launch, so they are
// read through the read-only path. c4, ch, the mask and the scratch rows
// are in kernel time [T, G, B, .]; dy, dxp and dhn are found through a
// Layout (below), so K2-bwd reads and writes K2's frame-ordered tensors in
// place, group 1 reversed by addressing.
//
// Grid: K5's persistent cooperative grid, one CTA per SM. CTA (g, s, c)
// owns hidden units j0 .. j0+U-1 of group g and the batch rows
// [s Bs, (s+1) Bs). It keeps the U rows of wh[g] (the columns of wh^T for
// its units, 3H wide, zero past H and 3H) resident in shared memory in T,
// or, where they do not fit beside the ring (STREAM, chosen by the plan),
// streams them: each K chunk of the U rows goes through the ring beside
// the chunk of dhproj rows, every pass of every step.
// dh[b, j] needs all 3H of the step before's dhproj, so each step every
// CTA writes its units' dhproj (rounded to T, as the product wants it)
// into a double-buffered exchange row in global memory and meets the
// other CTAs of (g, s) at their barrier.
//
// The per-step product [Bs, 3H] x [3H, U] runs on the tensor cores
// (mma_sync.cuh: bf16 directly, f32 as 3xTF32). The split's dhproj rows
// stream from L2 (cp.async.cg: the same launch wrote them before the
// barrier) in K chunks of BK elements through a ring of STAGES stages, BK
// as large as the shared memory left beside wh allows. A warp computes a
// tile of 16 MT rows x 8 NT units (16 x 16, or 32 x 32, where its
// fragments serve four times the mmas and the f32 splits cost less per
// product); the 8 warps stand WN along the units, WM along the rows (a
// pass of R = 16 MT WM rows) and WK along K, each taking every WK-th pair
// of product steps of a chunk, so a small split (few rows, as at offline
// shapes) still keeps every warp busy. Fragments are loaded 16 bytes at a
// time with K permuted inside each pair of product steps (load_a2,
// load_b2), from rows padded to 16 mod 32 words. The warps' partial tiles
// meet in shared memory (the ring's space) and every thread then runs the
// epilogue for a few (row, unit pair) items, adding the WK partials in
// order (deterministic): dh = chd + acc, d = dh + dy, e = c4 d, the
// outputs, the exchange row and ch d, kept for the next step in a global
// f32 scratch [G, B, H] that the same thread reads back (same items every
// step). The epilogue's inputs are loaded before the product, so their
// latency hides behind it.
#pragma once

#include "grid_sync.cuh"
#include "mma_sync.cuh"

namespace gru_bwd {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;     // depth of the cp.async ring
constexpr int GRAIN = 256;    // bytes: the K chunk is a multiple of it
constexpr int ITEMS = 4;      // epilogue items (row, unit pair) per thread, at most

template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 64 / sizeof(T);  // 16 words: row pitches of 16 mod 32 words
}
// K rounded up to 128 bytes: the K extent of a product (the chain's 3H,
// K5's H), and the length of resident wh rows
template <typename T>
__host__ __device__ inline int k_round(int K) {
  constexpr int q = 128 / sizeof(T);
  return (K + q - 1) / q * q;
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

// Where a row of a tensor family lies. Row (kernel step t, group g, batch
// row b) starts at element
//   base + g gs + frame_g(t) st + b sb,  frame_g(t) = T-1-t for g >= rev_from, else t.
// K5, K5-bwd and K8 address [T, G, B, W] rows (grouped_rows; no group
// reversed). K2 and K2-bwd address K2's tensors as they are (bigru_rows.cuh):
// p0 and p1 [T, B, 3H] (gs the distance between them), out and dout [T, B,
// 2H] with the directions side by side (gs = H, sb = 2H), group 1 reading
// its frames reversed, as the TPU kernel's flipped index maps do
// (pallas_gru.py:513).
template <typename P>
struct Rows {
  P* base;
  long long gs, st;
  int sb;
  __device__ __forceinline__ P* at(int f, int g, int b) const {
    return base + g * gs + f * st + (long long)b * sb;
  }
};

template <typename P>
inline Rows<P> grouped_rows(P* p, int G, int B, int W) {
  return Rows<P>{p, (long long)B * W, (long long)G * B * W, W};
}

// The families: the coefficient kernel reads xp and the forward's output
// ys (h_prev of step t is ys's row of step t-1); the chain reads dy and
// writes dxp (3H wide) and dhn (H wide).
template <typename T>
struct Layout {
  Rows<const T> xp, ys, dy;
  Rows<T> dxp, dhn;
  int rev_from;  // the first group that reads its frames reversed (G: none)
  __device__ __forceinline__ int frame(int t, int g, int Tn) const {
    return g >= rev_from ? Tn - 1 - t : t;
  }
};

// The forward's families (gru_fwd_kernel.cuh): it reads xp and writes ys,
// whose row of step t-1 is step t's h_prev.
template <typename T>
struct FwdLayout {
  Rows<const T> xp;
  Rows<T> ys;
  int rev_from;  // the first group that reads its frames reversed (G: none)
  __device__ __forceinline__ int frame(int t, int g, int Tn) const {
    return g >= rev_from ? Tn - 1 - t : t;
  }
};

// The epilogue's inputs of one row and unit pair, loaded ahead
struct Pre {
  float2 dy, cr, cz, cn, cnh, ch, chd;
};

// The reverse chain with warp tiles of 16 MT rows x 8 NT units, dy, dxp
// and dhn addressed through L. STREAM: wh through the ring. WM warps along
// the rows, BK elements per K chunk (from plan_grid).
template <typename T, typename C, int MT, int NT, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const C* __restrict__ c4, const float* __restrict__ ch, const Layout<T> L,
             const T* __restrict__ wh, float* chd, T* xch, unsigned* bar, int Tn, int G, int B,
             int H, int U, int nblk, int S, int Bs, int WM, int BK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  using Op = mma::Op<T>;
  constexpr int KP = 2 * Op::K_STEP, VEC = 16 / sizeof(T);  // K of a pair of product steps
  const Cta c = cta_place(U, nblk, S, Bs, B);
  const int g = c.g, H3 = 3 * H, KW = k_round<T>(H3);
  const int ALD = BK + row_pad<T>(), PIECES = BK / VEC, RLD = U + 8;
  const int WLD = STREAM ? ALD : KW + row_pad<T>();
  const int WN = U / (8 * NT), WK = WARPS / (WN * WM), R = 16 * MT * WM;
  const int nk = (KW + BK - 1) / BK, items = R * U / 2, stage = (R + (STREAM ? U : 0)) * ALD;
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int wn = warp % WN, wm = (warp / WN) % WM, wk = warp / (WN * WM);
  T* w_s = smem;                                    // [U][WLD] wh rows j0 .. j0+U-1 (resident)
  T* a_s = STREAM ? smem : smem + U * WLD;          // STAGES x [R (+ U)][ALD] K chunks
  float* part = reinterpret_cast<float*>(a_s);      // [WK][R][RLD] partial tiles
  const T* whg = wh + (size_t)g * H * H3;
  if (!STREAM) {
    for (int i = threadIdx.x; i < U * (KW / VEC); i += THREADS) {
      const int u = i / (KW / VEC), k = (i - u * (KW / VEC)) * VEC;
      const bool ok = c.j0 + u < H && k < H3;
      cp_async16(w_s + u * WLD + k, ok ? whg + (size_t)(c.j0 + u) * H3 + k : whg, ok);
    }
    cp_commit();
    cp_wait<0>();
  }
  __syncthreads();
  unsigned* gbar = bar + 2 * LINE * (g * S + c.s);
  // this group's rows of frame 0 (dxp and dhn may be blocks of one row: K8)
  const T* __restrict__ dy_g = L.dy.base + g * L.dy.gs;
  T* __restrict__ dxp_g = L.dxp.base + g * L.dxp.gs;
  T* __restrict__ dhn_g = L.dhn.base + g * L.dhn.gs;
  for (int step = 0; step < Tn; ++step) {
    const int t = Tn - 1 - step, f = L.frame(t, g, Tn);
    const T* dy_t = dy_g + f * L.dy.st;
    T* dxp_t = dxp_g + f * L.dxp.st;
    T* dhn_t = dhn_g + f * L.dhn.st;
    const T* xin = xch + ((size_t)((t + 1) & 1) * G + g) * B * H3;  // dhproj of step t + 1
    T* xout = xch + ((size_t)(t & 1) * G + g) * B * H3;
    for (int r0 = c.b_lo; r0 < c.b_hi; r0 += R) {
      // the epilogue's inputs: item i is row i / (U/2), units 2 (i % (U/2)) + 0, 1
      Pre pre[ITEMS];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = threadIdx.x + it * THREADS, r = i / (U / 2);
        const int b = r0 + r, j = c.j0 + 2 * (i - r * (U / 2));
        if (i >= items || b >= c.b_hi || j >= H) continue;  // H even: j + 1 < H too
        const size_t row = ((size_t)t * G + g) * B + b;
        const C* cc = c4 + row * 4 * H + j;
        Pre& p = pre[it];
        p.dy = mma::ld2(dy_t + (size_t)b * L.dy.sb + j);
        p.cr = mma::ld2(cc);
        p.cz = mma::ld2(cc + H);
        p.cn = mma::ld2(cc + 2 * H);
        p.cnh = mma::ld2(cc + 3 * H);
        p.ch = mma::ld2(ch + row * H + j);
        p.chd = step > 0 ? mma::ld2(chd + ((size_t)g * B + b) * H + j) : make_float2(0.f, 0.f);
      }
      if (step > 0) {
        float acc[MT][NT][4] = {}, lo[MT][NT][4] = {};
        __syncthreads();  // the ring is free: every thread is past the last pass
        auto load = [&](int kc) {
          if (kc < nk) {
            T* dst = a_s + (kc % STAGES) * stage;
            for (int i = threadIdx.x; i < R * PIECES; i += THREADS) {
              const int r = i / PIECES, kk = (i - r * PIECES) * VEC, k = kc * BK + kk;
              const bool ok = r0 + r < c.b_hi && k < H3;
              cp_async16(dst + r * ALD + kk, ok ? xin + (size_t)(r0 + r) * H3 + k : xin, ok);
            }
            if (STREAM) {
              for (int i = threadIdx.x; i < U * PIECES; i += THREADS) {
                const int u = i / PIECES, kk = (i - u * PIECES) * VEC, k = kc * BK + kk;
                const bool ok = c.j0 + u < H && k < H3;
                cp_async16(dst + (R + u) * ALD + kk,
                           ok ? whg + (size_t)(c.j0 + u) * H3 + k : whg, ok);
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
          const T* as = a_s + (kc % STAGES) * stage + wm * 16 * MT * ALD;
          const T* ws = STREAM ? a_s + (kc % STAGES) * stage + (R + wn * 8 * NT) * ALD
                               : w_s + wn * 8 * NT * WLD + kc * BK;
          const int kend = min(BK, KW - kc * BK);
          for (int kk = wk * KP; kk < kend; kk += WK * KP) {
            Op a[MT][2][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma::load_a2(a[mt], as + mt * 16 * ALD + kk, ALD);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              Op b[2][2];
              mma::load_b2(b, ws + nt * 8 * WLD + kk, WLD);
#pragma unroll
              for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma::mma(acc[mt][nt], lo[mt][nt], a[mt][s], b[s]);
            }
          }
        }
        cp_wait<0>();
        __syncthreads();  // the ring is free for the partial tiles
        float* pw = part + ((size_t)wk * R + wm * 16 * MT) * RLD + wn * 8 * NT;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma::st2(pw + (mt * 16 + gq + 8 * h) * RLD + nt * 8 + 2 * q,
                       acc[mt][nt][2 * h] + lo[mt][nt][2 * h],
                       acc[mt][nt][2 * h + 1] + lo[mt][nt][2 * h + 1]);
        __syncthreads();
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = threadIdx.x + it * THREADS, r = i / (U / 2), u = 2 * (i - r * (U / 2));
        const int b = r0 + r, j = c.j0 + u;
        if (i >= items || b >= c.b_hi || j >= H) continue;
        const Pre& p = pre[it];
        float dh0 = 0.f, dh1 = 0.f;
        if (step > 0) {
          float s0 = 0.f, s1 = 0.f;
          for (int kw = 0; kw < WK; ++kw) {
            const float2 v = mma::ld2(part + ((size_t)kw * R + r) * RLD + u);
            s0 += v.x, s1 += v.y;
          }
          dh0 = p.chd.x + s0;
          dh1 = p.chd.y + s1;
        }
        const float d0 = dh0 + p.dy.x, d1 = dh1 + p.dy.y;
        const float er0 = p.cr.x * d0, er1 = p.cr.y * d1, ez0 = p.cz.x * d0, ez1 = p.cz.y * d1;
        const float en0 = p.cn.x * d0, en1 = p.cn.y * d1;
        const float eh0 = p.cnh.x * d0, eh1 = p.cnh.y * d1;
        T* dx = dxp_t + (size_t)b * L.dxp.sb + j;
        mma::st2(dx, er0, er1);
        mma::st2(dx + H, ez0, ez1);
        mma::st2(dx + 2 * H, en0, en1);
        mma::st2(dhn_t + (size_t)b * L.dhn.sb + j, eh0, eh1);
        T* xo = xout + (size_t)b * H3 + j;
        mma::st2(xo, er0, er1);
        mma::st2(xo + H, ez0, ez1);
        mma::st2(xo + 2 * H, eh0, eh1);
        mma::st2(chd + ((size_t)g * B + b) * H + j, p.ch.x * d0, p.ch.y * d1);
      }
    }
    dir_barrier(gbar, (unsigned)nblk);
  }
}

// The chain's warp tiles: 16 x 16 (MT 1, NT 2) and 32 x 32 (MT 2, NT 4).
constexpr int TILES = 2;
constexpr int TILE_MT[TILES] = {1, 2}, TILE_NT[TILES] = {2, 4};
constexpr int MAX_UNITS = 64;  // the widest CTA: G ceil(H / 64) CTAs must fit the SMs

// A per-step product [R rows, K] x [K, cols U] of the persistent grids (the
// chain: K = 3H, one column per unit, wh's rows n-major; K5: K = H, the r, z
// and n columns of each unit, wh's columns k-major as stored), for the plan.
struct Operands {
  int K, cols;
  bool kmajor;  // streamed wh chunks are [BK][cols U] (else [cols U][BK])
};

// Shared memory in T: cols U resident rows of wh (none when streamed), the
// ring of STAGES x (R rows of BK, and the chunk of wh when streamed); the
// partial tiles [WK][R][cols U + 8] f32 reuse the ring.
template <typename T>
inline size_t wh_smem(const Operands& o, int U) {
  return (size_t)o.cols * U * (k_round<T>(o.K) + row_pad<T>()) * sizeof(T);
}
template <typename T>
inline size_t ring_smem(const Operands& o, int R, int BK, int U, bool stream) {
  const int n = o.cols * U;
  const size_t w = !stream   ? 0
                   : o.kmajor ? (size_t)BK * (n + 16 / sizeof(T))
                              : (size_t)n * (BK + row_pad<T>());
  return STAGES * ((size_t)R * (BK + row_pad<T>()) + w) * sizeof(T);
}
inline size_t partial_smem(const Operands& o, int WK, int R, int U) {
  return (size_t)WK * R * (o.cols * U + 8) * sizeof(float);
}

struct Plan {
  int stream, tile, U, nblk, S, Bs, WM, BK;
  size_t smem;
  long work, bytes;
};

// The launch plan of a cooperative grid over G groups, `nblk` CTAs of U
// units per batch split, one CTA per SM (the ring takes the shared memory
// that wh leaves). wh stays resident where some plan fits it; only where
// none does (its rows too long for shared memory at every U whose grid the
// SMs hold) is it streamed. For each warp tile (tile_mt x 16 rows, tile_nt
// x 8 units) and unit width: the most batch splits the SMs hold (down to 16
// rows a split), the fewest warps along the rows that cover a split in one
// pass (at most 8 / WN, a pass of at most 2048 row-units for the
// epilogue's items, and fewer where the ring would not fit), and the
// largest K chunk (a multiple of GRAIN bytes) that fits. Among them the
// least work per SM and step (row-units of its passes, padded to whole
// warp tiles), then the fewest rows restaged per SM and step (A rows, and
// wh's when streamed), then the fewest CTAs per split, then the larger
// warp tile. kernels[stream][tile] is the kernel of each mode and warp
// tile. No plan: G ceil(H / MAX_UNITS) CTAs exceed the SMs.
template <typename T, typename K>
cudaError_t plan_grid(const K (&kernels)[2][TILES], const int (&tile_mt)[TILES],
                      const int (&tile_nt)[TILES], const Operands& o, int max_groups, int G,
                      int B, int H, Plan* best) {
  int sms = 0, smem_max = 0;
  cudaError_t e = uasr_coop_limits(&sms, &smem_max);
  if (e != cudaSuccess) return e;
  const int KW = k_round<T>(o.K), grain = GRAIN / sizeof(T);
  const size_t cap = smem_max;
  *best = Plan{0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int stream = 0; stream < 2 && best->tile < 0; ++stream) {
    for (int tile = 0; tile < TILES; ++tile) {
      const int MT = tile_mt[tile], NT = tile_nt[tile];
      for (int U = 8 * NT; U <= MAX_UNITS; U *= 2) {
        const int WN = U / (8 * NT), nblk = (H + U - 1) / U;
        if (WN > WARPS || G * nblk > sms) continue;
        int S = min(sms / (G * nblk), (B + 15) / 16);
        S = max(1, min(S, max_groups / G));
        const int Bs = (B + S - 1) / S;
        S = (B + Bs - 1) / Bs;  // no empty split
        const size_t w = stream ? 0 : wh_smem<T>(o, U);
        int WM = 1;
        while (2 * WM * WN <= WARPS && 16 * MT * WM < Bs &&
               32 * MT * WM * U <= 2 * ITEMS * THREADS)
          WM *= 2;
        while (WM > 1 && w + ring_smem<T>(o, 16 * MT * WM, grain, U, stream) > cap) WM /= 2;
        const int R = 16 * MT * WM, WK = WARPS / (WN * WM), passes = (Bs + R - 1) / R;
        const size_t part = partial_smem(o, WK, R, U);
        int BK = grain;
        while (BK < KW && w + ring_smem<T>(o, R, BK + grain, U, stream) <= cap) BK += grain;
        while (ring_smem<T>(o, R, BK, U, stream) < part) BK += grain;  // room for the partials
        const size_t smem = w + ring_smem<T>(o, R, BK, U, stream);
        if (smem > cap) continue;
        const long per_sm = (G * S * nblk + sms - 1) / sms;
        const long work = per_sm * passes * R * U;
        const long bytes = per_sm * (Bs + (stream ? (long)passes * o.cols * U : 0));
        const bool better =
            best->tile < 0 || work < best->work ||
            (work == best->work &&
             (bytes < best->bytes ||
              (bytes == best->bytes &&
               (nblk < best->nblk || (nblk == best->nblk && tile > best->tile)))));
        if (better) *best = Plan{stream, tile, U, nblk, S, Bs, WM, BK, smem, work, bytes};
      }
    }
  }
  if (best->tile < 0) return cudaErrorCooperativeLaunchTooLarge;
  const K kernel = kernels[best->stream][best->tile];
  e = uasr_set_smem(kernel, best->smem);
  int occ = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, best->smem);
  if (e != cudaSuccess) return e;
  return occ >= 1 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

// Plan and launch the reverse chain (one cooperative launch). Scratch:
// chd [G, B, H] f32, xch [2, G, B, 3H] of T, bar 2 * LINE * max_groups
// zeroed words. *units, *splits: the plan's hidden units per CTA and batch
// splits per group; *streamed: 1 where wh streams through the ring.
template <typename T, typename C>
cudaError_t launch_chain(const C* c4, const float* ch, const Layout<T>& L, const T* wh,
                         float* chd, T* xch, unsigned* bar, int max_groups, int Tn, int G, int B,
                         int H, cudaStream_t stream, int* units, int* splits, int* streamed) {
  using Kernel = decltype(&chain_kernel<T, C, 1, 2, false>);
  const Kernel kernels[2][TILES] = {
      {chain_kernel<T, C, TILE_MT[0], TILE_NT[0], false>,
       chain_kernel<T, C, TILE_MT[1], TILE_NT[1], false>},
      {chain_kernel<T, C, TILE_MT[0], TILE_NT[0], true>,
       chain_kernel<T, C, TILE_MT[1], TILE_NT[1], true>}};
  Plan best;
  cudaError_t e = plan_grid<T>(kernels, TILE_MT, TILE_NT, Operands{3 * H, 1, false},
                                max_groups, G, B, H, &best);
  if (e != cudaSuccess) return e;
  *units = best.U;
  *splits = best.S;
  *streamed = best.stream;
  int U = best.U, nblk = best.nblk, S = best.S, Bs = best.Bs, WM = best.WM, BK = best.BK;
  void* args[] = {&c4, &ch, const_cast<Layout<T>*>(&L), &wh, &chd, &xch, &bar, &Tn, &G, &B, &H,
                  &U, &nblk, &S, &Bs, &WM, &BK};
  e = cudaLaunchCooperativeKernel((const void*)kernels[best.stream][best.tile],
                                  dim3(G * S * nblk), dim3(THREADS), args, best.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace gru_bwd
