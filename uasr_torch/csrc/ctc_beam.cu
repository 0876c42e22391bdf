// K4: exact CTC prefix beam search for Hopper (sm_90a), resumable.
//
// Replaces the TPU kernel uasr/ops/pallas_beam.py::_beam_kernel (reached
// through ctc_beam_search_decode_pallas), with its semantics:
//   - candidates per step: W*V extends (ext, index w*V + c) then W stays;
//     no per-beam pruning (exact, prune >= V);
//   - the only possible duplicate, ext(w, c) == stay(w') with
//     c == last[w'], is folded into the stay by hash comparison, beams
//     w' in order, each fold a left fold of logaddexp over w;
//   - top-W = W rounds of (max, lowest-index argmax, mask to NEG);
//   - a selected candidate's hashes derive from (parent hash, char),
//     wrapping mod 2^32 (uint32 here: signed overflow is undefined in
//     C++), and dead selections get the per-slot sentinels SENT + w;
//   - optional bigram [V+1, V] / trigram [(V+1)^2, V] LM, read by a
//     direct gather of row hist (trigram: hist2 * (V+1) + hist);
//   - finished utterances freeze and emit parent = w, char = -1.
// The beam state (last, last2, hash1, hash2 as int32 bit patterns; p_b,
// p_nb) comes in and goes out, so a decode can be fed in chunks: chunks
// of one log-prob sequence, each started from the state the previous one
// left, give the same bits as one pass (the streaming beam,
// uasr_torch/serve.py).
// Inputs: log-softmax [B, T, V] f32, lengths [B] int32, LM table or null,
// state [4, B, W] int32 + [2, B, W] f32. Outputs: backpointers
// parents/chars [T, B, W] int32 and the state after the last step; the
// traceback runs outside (uasr_torch/ops/cuda_beam.py).
//
// Bound: a chain of T dependent steps; the bytes (log-probs in,
// backpointers out) are small, so the latency of a step sets the time: a
// warp-wide sort, a lae (expf and log1pf) and a redux.sync each cost far
// more than an ALU op, and redux.syncs in a row do not pipeline, so the
// step keeps few of each on its chain. Design: one CTA per utterance with
// the whole T loop inside, four warps (one a scheduler) up to W*V = 2048
// and eight above, and a cluster of two CTAs from W*V = 8192; per step:
//   - row: step t+1's log-prob row is copied into the second of two
//     shared buffers by 4-byte cp.async during step t (a row of odd V is
//     not 16-byte aligned), so no step waits on a global load;
//   - matches (warp 0): every (beam, beam') hash test spread over the
//     lanes, the earlier beams with the same last symbol by match.any;
//     then the stays (warp 0, while the other warps start their extends),
//     each fold only over the beams it takes (__ffs, ascending): lae(x, NEG)
//     is x + 0 bit for bit, so the NEG terms of the left fold change
//     nothing; a beam's total for the next step is its stay's value or, for
//     an extend, that identity, so the rebuild runs no lae;
//   - small vocabularies (V <= 32, four warps: a lane a symbol, W/4 beams a
//     warp): each beam's best extend (a shuffle butterfly) and the W stays
//     are 2W candidates whose W-th best every top-W candidate reaches; the
//     ones at or above it (at most 32, else the general pass below) are
//     gathered and sorted over warp 0's lanes by a bitonic network;
//   - general pass (every thread): for each of its symbols c the W extends
//     ext(w, c) in registers, its largest log-prob's first, sorted by a
//     bitonic network into the thread's list of LW (W rounded up to a
//     power of two); then a bound on the CTA's W-th best (the W-th best
//     lane head, the best lane's W-th entry, the best of the warps'), and
//     the other symbols' extends inserted branch-free only where some lane
//     has one at or above it (without an LM a symbol is skipped outright
//     when max_w total[w] + lp[c], which tops its extends, is below it);
//     the CTA's entries at or above their warp's bound (every one of the
//     CTA's top W is among them) are gathered and sorted over warp 0's
//     lanes; past 32 of them, each warp's are sorted over its lanes, or,
//     past 32 in a warp, the warp merges its 32 lists in five
//     rounds of the bitonic top-LW merge (best-of against the partner
//     lane's list reversed, log2(LW) clean stages) and warp 0 merges the
//     warp lists the same way over groups of LW lanes; in a cluster each CTA
//     takes half of the symbols, the two swap their lists through
//     distributed shared memory (one cluster barrier a step) and both merge
//     them, so both hold the same top W and rebuild the same beams; the
//     rank-0 CTA writes;
//   - rebuild (warp 0, lane w the w-th pick): once fewer than W candidates
//     are above NEG, the rounds re-pick a column already taken (their NEG
//     mask ties with it): one ballot and one redux.sync reproduce that.
// The order (score desc, index asc) is total over unique indices, so an
// exact merge keeps what the W rounds of (max, lowest-index argmax) pick.
// The PHASES build stamps thread 0's clock64() per phase (the compiler may
// move arithmetic across a stamp: the shares are approximate, the sum not).

#include <cooperative_groups.h>
#include <limits.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr uint32_t HASH_MULT = 2654435761u;  // Knuth multiplicative hash
constexpr uint32_t HASH2_MULT = 40503u;
constexpr uint32_t SENT1 = 0xC0000000u;  // -0x40000000 as a 32-bit pattern
constexpr uint32_t SENT2 = 0xE0000000u;  // -0x20000000
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NWARPS = 8;
constexpr int MAX_W = 32;
constexpr int MAX_V = 16384;  // 12 V bytes of dynamic shared memory = 192 KB
// up to this many extend candidates per step a CTA is SMALL_NWARPS warps
// (one a scheduler of the SM), above it MAX_NWARPS
constexpr int SMALL_MAX_WV = 2048;
constexpr int SMALL_NWARPS = 4;
// from this many a cluster of two CTAs shares each utterance's extends
constexpr int CLUSTER_MIN_WV = 8192;
// phase stamps (uasr_ctc_beam_phases): thread 0's clock64() deltas per
// phase, summed over the steps
enum { PH_ROW, PH_STAYS, PH_CAND, PH_MERGE, PH_REBUILD, PH_BARRIER, NPHASES };

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, NEG);
  return m <= NEG ? NEG : ms + log1pf(expf(fminf(a, b) - ms));
}

// lae(x, NEG) and lae(NEG, x), bit for bit: exp(NEG - x) is 0 for x > NEG,
// so lae adds log1p(0) = +0 to x (and a lae is long on the step's chain)
__device__ __forceinline__ float lae_neg(float x) { return x > NEG ? __fadd_rn(x, 0.0f) : NEG; }

// (score desc, index asc): the order W rounds of (max, lowest index) pick in
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// a uint32 in the order of the float (-0 counted as +0), for redux.sync
__device__ __forceinline__ uint32_t okey(float v) {
  const uint32_t k = __float_as_uint(__fadd_rn(v, 0.0f));
  return k & 0x80000000u ? ~k : k | 0x80000000u;
}

__device__ __forceinline__ float okey_val(uint32_t k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// the r-th largest (0-based) of the warp's 32 keys, by a bitonic sort
__device__ __forceinline__ uint32_t shfl_rank_key(int lane, uint32_t x, int r) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint32_t y = __shfl_xor_sync(FULL, x, j);
      x = ((lane & j) == 0) == ((lane & k) == 0) ? max(x, y) : min(x, y);
    }
  }
  return __shfl_sync(FULL, x, r);
}

// compare-exchange of lanes lane and lane ^ j: the lower keeps the better
// when `down`, the worse otherwise
__device__ __forceinline__ void lane_ce(int lane, int j, bool down, float& v, int& i) {
  const float pv = __shfl_xor_sync(FULL, v, j);
  const int pi = __shfl_xor_sync(FULL, i, j);
  const bool pb = better(pv, pi, v, i);
  if (((lane & j) == 0) == down ? pb : !pb) {
    v = pv;
    i = pi;
  }
}

// sort one candidate a lane over the warp, best in lane 0
__device__ __forceinline__ void warp_sort(int lane, float& v, int& i) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) lane_ce(lane, j, (lane & k) == 0, v, i);
  }
}

// A list sorted over each group of P lanes (lane k of the group holding
// entry k) merged with another such list given reversed (bv, bi: entry
// P - 1 - k): best-of, then the bitonic clean of the group.
template <int P>
__device__ __forceinline__ void dist_merge(int lane, float& v, int& i, float bv, int bi) {
  if (better(bv, bi, v, i)) {
    v = bv;
    i = bi;
  }
#pragma unroll
  for (int j = P >> 1; j > 0; j >>= 1) lane_ce(lane, j, true, v, i);
}

// A sorted (best first) list of LW candidates, statically indexed so it
// stays in registers; sentinels (-inf, INT_MAX) pad it.
template <int LW>
struct List {
  float v[LW];
  int i[LW];

  // the better of slots a and b into a
  __device__ __forceinline__ void ce(int a, int b) {
    const bool sw = better(v[b], i[b], v[a], i[a]);
    const float va = v[a], vb = v[b];
    const int ia = i[a], ib = i[b];
    v[a] = sw ? vb : va;
    v[b] = sw ? va : vb;
    i[a] = sw ? ib : ia;
    i[b] = sw ? ia : ib;
  }

  // bitonic sorting network
  __device__ __forceinline__ void sort() {
#pragma unroll
    for (int k = 2; k <= LW; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
        for (int a = 0; a < LW; ++a) {
          const int b = a ^ j;
          if (b > a) {
            if ((a & k) == 0)
              ce(a, b);
            else
              ce(b, a);
          }
        }
      }
    }
  }

  // the top LW of this list and the sorted list (bv, bi): best-of against
  // it reversed gives a bitonic sequence, which log2(LW) stages sort
  __device__ __forceinline__ void merge(const float (&bv)[LW], const int (&bi)[LW]) {
#pragma unroll
    for (int k = 0; k < LW; ++k) {
      if (better(bv[LW - 1 - k], bi[LW - 1 - k], v[k], i[k])) {
        v[k] = bv[LW - 1 - k];
        i[k] = bi[LW - 1 - k];
      }
    }
#pragma unroll
    for (int j = LW >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int a = 0; a < LW; ++a)
        if ((a ^ j) > a) ce(a, a ^ j);
    }
  }

  // merge with the list of lane ^ off (the whole warp calls it)
  __device__ __forceinline__ void merge_lane(int off) {
    float bv[LW];
    int bi[LW];
#pragma unroll
    for (int k = 0; k < LW; ++k) {
      bv[k] = __shfl_xor_sync(FULL, v[k], off);
      bi[k] = __shfl_xor_sync(FULL, i[k], off);
    }
    merge(bv, bi);
  }

  // insert (x, xi) if `on`: every slot decided at once, no serial chain
  __device__ __forceinline__ void insert(bool on, float x, int xi) {
    bool bt[LW];
#pragma unroll
    for (int k = 0; k < LW; ++k) bt[k] = on && better(x, xi, v[k], i[k]);
#pragma unroll
    for (int k = LW - 1; k > 0; --k) {
      v[k] = bt[k - 1] ? v[k - 1] : (bt[k] ? x : v[k]);
      i[k] = bt[k - 1] ? i[k - 1] : (bt[k] ? xi : i[k]);
    }
    v[0] = bt[0] ? x : v[0];
    i[0] = bt[0] ? xi : i[0];
  }

  // entry k of this lane's list
  __device__ __forceinline__ void at(int k, float& ov, int& oi) const {
    ov = v[0];
    oi = i[0];
#pragma unroll
    for (int j = 1; j < LW; ++j) {
      if (j == k) {
        ov = v[j];
        oi = i[j];
      }
    }
  }

  // the largest over the warp of each lane's W-th entry, as an okey
  __device__ __forceinline__ uint32_t wth_key(int W) const {
    float x;
    int xi;
    at(W - 1, x, xi);
    return __reduce_max_sync(FULL, okey(x));
  }

  // entry `lane` of lane 0's list (the whole warp calls it)
  __device__ __forceinline__ void spread(int lane, float& ov, int& oi) const {
    ov = -CUDART_INF_F;
    oi = INT_MAX;
#pragma unroll
    for (int k = 0; k < LW; ++k) {
      const float x = __shfl_sync(FULL, v[k], 0);
      const int xi = __shfl_sync(FULL, i[k], 0);
      if (k == lane) {
        ov = x;
        oi = xi;
      }
    }
  }
};

// Beam state and per-step scratch in shared memory (W <= MAX_W).
struct Beams {
  float pb[MAX_W], pnb[MAX_W], tot[MAX_W], st_pb[MAX_W], st_pnb[MAX_W], stay[MAX_W];
  int last[MAX_W], last2[MAX_W];
  uint32_t h1[MAX_W], h2[MAX_W], mmask[MAX_W];
  const float* lmr[MAX_W];  // each beam's LM row (null without an LM)
  float wl_v[MAX_NWARPS][MAX_W];  // the warp lists (NWARPS > 1)
  int wl_i[MAX_NWARPS][MAX_W];
  float px_v[2][MAX_W];  // the other CTA's list (cluster), by step parity
  int px_i[2][MAX_W];
  float cx_v[MAX_NWARPS][32];  // candidates at or above the bound, gathered for a
  int cx_i[MAX_NWARPS][32];    // sort: the CTA's in row 0, else a warp's in its row
  int ncx[2];  // how many were (past 32 not kept): small vocabularies, general
  uint32_t wbound[MAX_NWARPS];  // each warp's bound (okey)
  uint32_t bmax[MAX_W];  // each beam's best extend (okey), small vocabularies
};

// LM row of beam w (null without an LM)
__device__ __forceinline__ const float* lm_row(const Beams& s, int w, const float* lm,
                                               int lm_order, int V) {
  if (!lm_order) return nullptr;
  int hist = s.last[w] >= 0 ? s.last[w] : V;
  if (lm_order == 3) hist += (s.last2[w] >= 0 ? s.last2[w] : V) * (V + 1);
  return lm + (size_t)hist * V;
}

// ext(w, c) before the fold, for beam w's (last, p_b, total, LM row): the
// TPU kernel's arithmetic, LM terms as an unfused multiply-add
__device__ __forceinline__ float ext_value(int c, int lw, float pbw, float totw,
                                           const float* lp, const float* lmr, float lm_weight,
                                           float lm_bonus, int blank) {
  float e = (c == lw ? pbw : totw) + lp[c];
  if (lmr) e = __fadd_rn(__fadd_rn(e, __fmul_rn(lm_weight, lmr[c])), lm_bonus);
  return c == blank ? NEG : e;
}

template <int LW, int NWARPS, int CL, bool PHASES>
__global__ void __launch_bounds__(NWARPS * 32)
ctc_beam_kernel(const float* __restrict__ logp, const int* __restrict__ lengths,
                const float* __restrict__ lm, int lm_order, float lm_weight,
                float lm_bonus, int Tn, int B, int V, int W, int blank,
                const int* __restrict__ istate_in, const float* __restrict__ fstate_in,
                int* __restrict__ parents, int* __restrict__ chars,
                int* __restrict__ istate_out, float* __restrict__ fstate_out,
                long long* __restrict__ phases) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lpbuf = reinterpret_cast<float*>(smem_raw);             // [2][V] log-prob rows
  uint32_t* fmark = reinterpret_cast<uint32_t*>(lpbuf + 2 * V);  // [V] fold marks, bit w
  __shared__ Beams s;
  constexpr int NTHREADS = NWARPS * 32;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rank = 0;
  if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
  const bool writer = rank == 0;
  const int b = blockIdx.x / CL;
  const int WV = W * V;
  const size_t BW = (size_t)B * W;
  const int Tact = min(max(lengths[b], 0), Tn);
  const float* urow = logp + (size_t)b * Tn * V;
  if (tid < W) {
    const size_t o = (size_t)b * W + tid;
    s.last[tid] = istate_in[o];
    s.last2[tid] = istate_in[BW + o];
    s.h1[tid] = (uint32_t)istate_in[2 * BW + o];
    s.h2[tid] = (uint32_t)istate_in[3 * BW + o];
    s.pb[tid] = fstate_in[o];
    s.pnb[tid] = fstate_in[BW + o];
    s.tot[tid] = lae(s.pb[tid], s.pnb[tid]);  // then kept by each rebuild
  }
  for (int c = tid; c < V; c += NTHREADS) fmark[c] = 0u;
  if (Tact > 0)
    for (int c = tid; c < V; c += NTHREADS) cp_async4(lpbuf + c, urow + c);
  cp_commit();
  // (cluster: the other CTA runs before its shared memory is written)
  if constexpr (CL > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  long long ph[NPHASES] = {}, t_prev = PHASES ? clock64() : 0;
  auto stamp = [&](int p) {
    if constexpr (PHASES) {
      const long long now = clock64();
      ph[p] += now - t_prev;
      t_prev = now;
    }
  };
  auto barrier = [&](int p) {
    stamp(p);
    __syncthreads();
    stamp(PH_BARRIER);
  };
  // the candidates at or above a bound on the CTA's W-th best, gathered
  // into row 0 (count g zeroed at the step's start), then sorted over warp
  // 0's lanes when at most 32: true then, CTA-wide, lane k of warp 0 the
  // k-th pick
  auto gather = [&](int g, float v, int i) {
    const int at = atomicAdd(&s.ncx[g], 1);
    if (at < 32) {
      s.cx_v[0][at] = v;
      s.cx_i[0][at] = i;
    }
  };
  auto sort_gathered = [&](int g, int p, float& mv, int& mi) {
    barrier(p);
    const int total = s.ncx[g];
    if (total > 32) return false;
    if (warp == 0) {
      mv = lane < total ? s.cx_v[0][lane] : -CUDART_INF_F;
      mi = lane < total ? s.cx_i[0][lane] : INT_MAX;
      warp_sort(lane, mv, mi);
    }
    return true;
  };

  for (int t = 0; t < Tact; ++t) {
    const float* lp = lpbuf + (t & 1) * V;
    cp_wait<0>();
    barrier(PH_ROW);  // row t in; the last step's beams written
    if (t + 1 < Tact) {
      float* nxt = lpbuf + ((t + 1) & 1) * V;
      const float* src = urow + (size_t)(t + 1) * V;
      for (int c = tid; c < V; c += NTHREADS) cp_async4(nxt + c, src + c);
    }
    cp_commit();
    if (tid == 0) s.ncx[0] = s.ncx[1] = 0;
    stamp(PH_ROW);

    // ---- warp 0: hash matches, fold marks (bit w of mm: ext(w, last[lane])
    // is stay(lane); eff: the bits no earlier beam with the same last
    // symbol takes, so an extend folds into the first stay it matches)
    uint32_t eff = 0u;
    if (warp == 0) {
      const bool on = lane < W;
      const int cp = on ? s.last[lane] : -1;
      if (on) s.lmr[lane] = lm_row(s, lane, lm, lm_order, V);
      // lane l tests its share of the beams w against beam l % LW
      constexpr int PER = LW * LW / 32;
      const int wq = lane % LW, w0 = lane / LW * PER;
      const int cw = wq < W ? s.last[wq] : -1;
      const uint32_t h1q = s.h1[wq], h2q = s.h2[wq];
      uint32_t mm = 0u;
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int w = w0 + m;
        if (w < W && cw >= 0 && s.h1[w] * HASH_MULT + (uint32_t)(cw + 1) == h1q &&
            s.h2[w] * HASH2_MULT + (uint32_t)(cw + 7) == h2q)
          mm |= 1u << w;
      }
#pragma unroll
      for (int o = LW; o < 32; o <<= 1) mm |= __shfl_xor_sync(FULL, mm, o);
      mm = on ? mm : 0u;
      const uint32_t same = __match_any_sync(FULL, on ? cp : -2 - lane);
      if (on) s.mmask[lane] = mm;
      __syncwarp();
      uint32_t taken = 0u;
      for (uint32_t q = same & ((1u << lane) - 1u); q; q &= q - 1) taken |= s.mmask[__ffs(q) - 1];
      eff = mm & ~taken;
      if (mm) atomicOr(&fmark[cp], mm);
    }
    barrier(PH_STAYS);
    // ---- warp 0: the stays, each fold a left fold over the beams it takes
    // (the other warps start on their extends)
    if (warp == 0 && lane < W) {
      const int cp = s.last[lane];
      float fold = NEG;
      for (; eff; eff &= eff - 1) {
        const int q = __ffs(eff) - 1;
        const float ctb = ext_value(cp, s.last[q], s.pb[q], s.tot[q], lp, s.lmr[q], lm_weight,
                                    lm_bonus, blank);
        fold = q == 0 ? ctb : fold <= NEG ? lae_neg(ctb) : lae(fold, ctb);
      }
      const float st_pb = s.tot[lane] + lp[blank];
      const float own = cp >= 0 ? s.pnb[lane] + lp[cp] : NEG;
      const float st_pnb = fold == NEG ? lae_neg(own) : lae(own, fold);
      s.st_pb[lane] = st_pb;
      s.st_pnb[lane] = st_pnb;
      s.stay[lane] = lae(st_pb, st_pnb);
    }
    __syncwarp();
    stamp(PH_STAYS);

    // ---- every thread: the extends of its symbols, then warp 0 the stays
    float mv;  // after the merges, lane k of warp 0: the k-th pick
    int mi;
    bool picked = false;
    if constexpr (CL == 1 && NWARPS == SMALL_NWARPS) {
      // One symbol a lane (V <= 32), LW / NWARPS beams a warp. Each beam's
      // best extend and the W stays are 2W candidates, so every top-W
      // candidate is at or above the W-th best of them (W <= 16; past that
      // the least of either set); when at most 32 are, warp 0 sorts them
      // over its lanes. Else the lists decide.
      if (V <= 32) {
        constexpr int BPW = LW / NWARPS;
        const bool valid = lane < V;
        const float l = valid ? lp[lane] : 0.f;
        const uint32_t fm = !valid || lane == blank ? FULL : fmark[lane];
        float e[BPW], bm[BPW];
#pragma unroll
        for (int k = 0; k < BPW; ++k) {
          const int w = warp * BPW + k;
          e[k] = -CUDART_INF_F;
          if (w < W) {
            float x = (lane == s.last[w] ? s.pb[w] : s.tot[w]) + l;
            if (lm_order && valid)
              x = __fadd_rn(__fadd_rn(x, __fmul_rn(lm_weight, s.lmr[w][lane])), lm_bonus);
            e[k] = (fm >> w) & 1u ? NEG : x;
          }
          bm[k] = valid ? e[k] : -CUDART_INF_F;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int k = 0; k < BPW; ++k) bm[k] = fmaxf(bm[k], __shfl_xor_sync(FULL, bm[k], o));
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < BPW; ++k)
            if (warp * BPW + k < W) s.bmax[warp * BPW + k] = okey(bm[k]);
        }
        barrier(PH_CAND);
        uint32_t th;
        if constexpr (LW <= 16) {
          // the W-th best of the 2W, one a lane, sorted by every warp
          const uint32_t key = lane < W ? s.bmax[lane]
                               : lane - LW >= 0 && lane - LW < W ? okey(s.stay[lane - LW])
                                                                 : 0u;
          th = shfl_rank_key(lane, key, W - 1);
        } else {
          // the least of either set
          uint32_t ts = UINT_MAX;
          th = UINT_MAX;
#pragma unroll
          for (int k = 0; k < LW; ++k) {
            if (k < W) {
              th = min(th, s.bmax[k]);
              ts = min(ts, okey(s.stay[k]));
            }
          }
          th = max(th, ts);
        }
#pragma unroll
        for (int k = 0; k < BPW; ++k) {
          const int w = warp * BPW + k;
          if (w < W && valid && okey(e[k]) >= th) gather(0, e[k], w * V + lane);
        }
        if (warp == 0 && lane < W && okey(s.stay[lane]) >= th) gather(0, s.stay[lane], WV + lane);
        picked = sort_gathered(0, PH_CAND, mv, mi);
      }
    }
    if (!picked) {
      List<LW> top;
      uint32_t bound;  // okey of a lower bound on the CTA's W-th best candidate
      {
        float totr[LW], pbr[LW];
        int lastr[LW];
        const float* lmrr[LW];
        float maxtot = NEG;  // p_b <= total, so no extend of c tops maxtot + lp[c]
#pragma unroll
        for (int k = 0; k < LW; ++k) {
          const int w = k < W ? k : 0;
          totr[k] = s.tot[w];
          pbr[k] = s.pb[w];
          lastr[k] = s.last[w];
          lmrr[k] = s.lmr[w];
          maxtot = fmaxf(maxtot, totr[k]);
        }
        // ext(k, c) of the LW beams, -inf past W or where `skip`
        auto extends = [&](int c, bool skip, float (&e)[LW]) {
          const float l = skip ? 0.f : lp[c];
          const uint32_t fm = skip || c == blank ? FULL : fmark[c];
#pragma unroll
          for (int k = 0; k < LW; ++k) {
            float x = (c == lastr[k] ? pbr[k] : totr[k]) + l;
            if (lm_order && !skip)
              x = __fadd_rn(__fadd_rn(x, __fmul_rn(lm_weight, lmrr[k][c])), lm_bonus);
            x = (fm >> k) & 1u ? NEG : x;
            e[k] = k >= W || skip ? -CUDART_INF_F : x;
          }
        };
        constexpr int STRIDE = NTHREADS * CL;
        const int c_first = rank * NTHREADS + tid;
        // the lead symbol, the thread's largest log-prob (lowest index of
        // equals; not blank): its extends first, so the bounds start high
        int lead = -1;
        float lead_lp = 0.f;
        for (int c = c_first; c < V; c += STRIDE) {
          if (c != blank && (lead < 0 || lp[c] > lead_lp)) {
            lead = c;
            lead_lp = lp[c];
          }
        }
        {
          float e[LW];
          extends(lead, lead < 0, e);
#pragma unroll
          for (int k = 0; k < LW; ++k) {
            top.v[k] = e[k];
            top.i[k] = k < W && lead >= 0 ? k * V + lead : INT_MAX;
          }
          top.sort();
        }
        // the W-th best lane head, and the best lane's W-th entry: each has W
        // of the warp's candidates at or above it
        bound = max(shfl_rank_key(lane, okey(top.v[0]), W - 1), top.wth_key(W));
        if constexpr (NWARPS > 1) {
          // each warp's bound is one on the CTA's W-th best: share the best
          if (lane == 0) s.wbound[warp] = bound;
          barrier(PH_CAND);
#pragma unroll
          for (int j = 0; j < NWARPS; ++j) bound = max(bound, s.wbound[j]);
        }
        for (int c0 = 0; c0 < V; c0 += STRIDE) {
          const int c = c0 + c_first;
          const float th = okey_val(bound);
          // without an LM a symbol whose extends all fall below the bound
          // (masked ones are NEG) is skipped on one add
          const bool skip = c >= V || c == lead ||
                            (lm_order == 0 && fmaxf(maxtot + lp[c], NEG) < th);
          if (__all_sync(FULL, skip)) continue;
          float e[LW];
          extends(c, skip, e);
          bool pass[LW], any = false;
#pragma unroll
          for (int k = 0; k < LW; ++k) {
            pass[k] = !skip && e[k] >= th;
            any |= pass[k];
          }
          if (__any_sync(FULL, any)) {
#pragma unroll
            for (int k = 0; k < LW; ++k)
              if (k < W && __any_sync(FULL, pass[k])) top.insert(pass[k], e[k], k * V + c);
            bound = max(bound, top.wth_key(W));
          }
        }
      }
      if (warp == 0 && writer) {
        top.insert(lane < W, lane < W ? s.stay[lane] : 0.f, WV + lane);
        bound = max(bound, top.wth_key(W));
      }
      stamp(PH_CAND);

      // ---- merges, to lane k of warp 0 holding the k-th pick: the CTA's
      // entries at or above their warp's bound (a prefix of each list below
      // W: every one of the CTA's top W is among them) sorted at once; past
      // 32 of them, each warp's sorted alone, or past 32 in a warp its lanes'
      // lists merged; then the warp lists merged in warp 0
      int n = 0;
#pragma unroll
      for (int k = 0; k < LW; ++k) n += k < W && top.i[k] != INT_MAX && okey(top.v[k]) >= bound;
      if (n) {
        const int at = atomicAdd(&s.ncx[1], n);
#pragma unroll
        for (int k = 0; k < LW; ++k) {
          if (k < n && at + k < 32) {
            s.cx_v[0][at + k] = top.v[k];
            s.cx_i[0][at + k] = top.i[k];
          }
        }
      }
      if (!sort_gathered(1, PH_MERGE, mv, mi)) {
        if (__reduce_add_sync(FULL, n) <= 32) {
          int at = n;  // the warp's exclusive prefix
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, at, d);
            if (lane >= d) at += y;
          }
          at -= n;
          const int total = __shfl_sync(FULL, at + n, 31);
#pragma unroll
          for (int k = 0; k < LW; ++k) {
            if (k < n) {
              s.cx_v[warp][at + k] = top.v[k];
              s.cx_i[warp][at + k] = top.i[k];
            }
          }
          __syncwarp();
          mv = lane < total ? s.cx_v[warp][lane] : -CUDART_INF_F;
          mi = lane < total ? s.cx_i[warp][lane] : INT_MAX;
          warp_sort(lane, mv, mi);
        } else {
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) top.merge_lane(off);
          top.spread(lane, mv, mi);
        }
        if (lane < W) {
          s.wl_v[warp][lane] = mv;
          s.wl_i[warp][lane] = mi;
        }
        barrier(PH_MERGE);
        if (warp == 0) {
          // groups of LW lanes, one warp list each, merge the lists G apart
          // from shared memory, then each other group by shuffles
          constexpr int G = 32 / LW;
          const int g = lane / LW, k = lane % LW, r = LW - 1 - k;
          mv = g < NWARPS && k < W ? s.wl_v[g][k] : -CUDART_INF_F;
          mi = g < NWARPS && k < W ? s.wl_i[g][k] : INT_MAX;
#pragma unroll
          for (int j0 = G; j0 < NWARPS; j0 += G) {
            const bool real = j0 + g < NWARPS && r < W;
            dist_merge<LW>(lane, mv, mi, real ? s.wl_v[j0 + g][r] : -CUDART_INF_F,
                           real ? s.wl_i[j0 + g][r] : INT_MAX);
          }
#pragma unroll
          for (int lv = LW; lv < LW * (G < NWARPS ? G : NWARPS); lv <<= 1)
            dist_merge<LW>(lane, mv, mi, __shfl_xor_sync(FULL, mv, lv | (LW - 1)),
                           __shfl_xor_sync(FULL, mi, lv | (LW - 1)));
        }
      }
    }
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      if (warp == 0 && lane < W) {
        *cluster.map_shared_rank(&s.px_v[t & 1][lane], rank ^ 1) = mv;
        *cluster.map_shared_rank(&s.px_i[t & 1][lane], rank ^ 1) = mi;
      }
      stamp(PH_MERGE);
      cluster.sync();
      stamp(PH_BARRIER);
      if (warp == 0) {
        // the other CTA's list reversed over each group of LW lanes
        const int r = LW - 1 - lane % LW;
        const bool real = r < W;
        dist_merge<LW>(lane, mv, mi, real ? s.px_v[t & 1][r] : -CUDART_INF_F,
                       real ? s.px_i[t & 1][r] : INT_MAX);
      }
    }
    stamp(PH_MERGE);

    // ---- warp 0: reproduce the rounds, rebuild
    if (warp == 0) {
      // Once a round's best is not above NEG, the NEG written over the
      // columns already taken ties with it, and every later round takes
      // the lowest such column.
      const unsigned above = __ballot_sync(FULL, lane >= W || mv > NEG);
      if (above != FULL) {
        const int r0 = __ffs(~above) - 1;
        const float v0 = __shfl_sync(FULL, mv, r0);
        const int i0 = __shfl_sync(FULL, mi, r0);
        const unsigned low = __reduce_min_sync(FULL, lane < r0 ? (unsigned)mi : UINT_MAX);
        const unsigned m = min(r0 == 0 || v0 == NEG ? (unsigned)i0 : UINT_MAX, low);
        if (lane >= r0) mi = (int)m;
      }
      int n_last = 0, n_last2 = 0, parent = lane, ch = -1;
      uint32_t n_h1 = 0u, n_h2 = 0u;
      float n_pb = 0.f, n_pnb = 0.f, n_tot = 0.f;
      if (lane < W) {
        const int col = mi;
        const bool is_ext = col < WV;
        parent = is_ext ? col / V : col - WV;
        ch = is_ext ? col - parent * V : -1;
        n_pb = is_ext ? NEG : s.st_pb[parent];
        if (is_ext) {
          n_pnb = (fmark[ch] >> parent) & 1u
                      ? NEG
                      : ext_value(ch, s.last[parent], s.pb[parent], s.tot[parent], lp,
                                  s.lmr[parent], lm_weight, lm_bonus, blank);
        } else {
          n_pnb = s.st_pnb[parent];
        }
        const uint32_t p_h1 = s.h1[parent], p_h2 = s.h2[parent];
        n_h1 = is_ext ? p_h1 * HASH_MULT + (uint32_t)(ch + 1) : p_h1;
        n_h2 = is_ext ? p_h2 * HASH2_MULT + (uint32_t)(ch + 7) : p_h2;
        n_last = is_ext ? ch : s.last[parent];
        n_last2 = is_ext ? s.last[parent] : s.last2[parent];
        n_tot = is_ext ? lae_neg(n_pnb) : s.stay[parent];  // lae(n_pb, n_pnb)
        if (n_tot < 0.5f * NEG) {
          n_h1 = SENT1 + (uint32_t)lane;
          n_h2 = SENT2 + (uint32_t)lane;
        }
      }
      __syncwarp();
      if (lane < W) {
        if (s.mmask[lane]) fmark[s.last[lane]] = 0u;
        s.last[lane] = n_last;
        s.last2[lane] = n_last2;
        s.h1[lane] = n_h1;
        s.h2[lane] = n_h2;
        s.pb[lane] = n_pb;
        s.pnb[lane] = n_pnb;
        s.tot[lane] = n_tot;
        if (writer) {
          const size_t o = ((size_t)t * B + b) * W + lane;
          parents[o] = parent;
          chars[o] = ch;
        }
      }
    }
    stamp(PH_REBUILD);
  }
  __syncthreads();
  if (!writer) return;
  if constexpr (PHASES) {
    if (tid == 0)
      for (int p = 0; p < NPHASES; ++p) phases[(size_t)b * NPHASES + p] = ph[p];
  }
  // frozen steps: identity backpointers
  for (int i = tid; i < (Tn - Tact) * W; i += NTHREADS) {
    const int t = Tact + i / W, w = i % W;
    const size_t o = ((size_t)t * B + b) * W + w;
    parents[o] = w;
    chars[o] = -1;
  }
  if (tid < W) {
    const size_t o = (size_t)b * W + tid;
    istate_out[o] = s.last[tid];
    istate_out[BW + o] = s.last2[tid];
    istate_out[2 * BW + o] = (int)s.h1[tid];
    istate_out[3 * BW + o] = (int)s.h2[tid];
    fstate_out[o] = s.pb[tid];
    fstate_out[BW + o] = s.pnb[tid];
  }
}

struct Args {
  const float* logp;
  const int* lengths;
  const float* lm;
  int lm_order;
  float lm_weight, lm_bonus;
  int T, B, V, W, blank;
  const int* istate_in;
  const float* fstate_in;
  int *parents, *chars, *istate_out;
  float* fstate_out;
  long long* phases;
};

// warps per CTA and CTAs per utterance for W beams over V symbols
void plan(int W, int V, int* warps, int* ctas) {
  const int wv = W * V;
  *warps = wv <= SMALL_MAX_WV ? SMALL_NWARPS : MAX_NWARPS;
  *ctas = wv >= CLUSTER_MIN_WV ? 2 : 1;
}

template <int LW, int NWARPS, int CL, bool PHASES>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = ctc_beam_kernel<LW, NWARPS, CL, PHASES>;
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * CL);
  cfg.blockDim = dim3(NWARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a.logp, a.lengths, a.lm, a.lm_order, a.lm_weight,
                         a.lm_bonus, a.T, a.B, a.V, a.W, a.blank, a.istate_in, a.fstate_in,
                         a.parents, a.chars, a.istate_out, a.fstate_out, a.phases);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NWARPS, int CL, bool PHASES>
cudaError_t launch_lw(const Args& a, size_t smem, cudaStream_t stream) {
  if (a.W <= 8) return launch<8, NWARPS, CL, PHASES>(a, smem, stream);
  if (a.W <= 16) return launch<16, NWARPS, CL, PHASES>(a, smem, stream);
  return launch<32, NWARPS, CL, PHASES>(a, smem, stream);
}

template <bool PHASES>
cudaError_t run(const Args& a, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int T = a.T, B = a.B, V = a.V, W = a.W;
  if (W < 1 || W > MAX_W || V < 1 || V > MAX_V || T < 1 || B < 1 || a.blank < 0 || a.blank >= V)
    return cudaErrorInvalidValue;
  if ((a.lm_order != 0) != (a.lm != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)V * (2 * sizeof(float) + sizeof(uint32_t));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int warps, ctas;
  plan(W, V, &warps, &ctas);
  if (warps == SMALL_NWARPS) return launch_lw<SMALL_NWARPS, 1, PHASES>(a, smem, s);
  if (ctas == 1) return launch_lw<MAX_NWARPS, 1, PHASES>(a, smem, s);
  return launch_lw<MAX_NWARPS, 2, PHASES>(a, smem, s);
}

}  // namespace

// logp [B, T, V] f32, lengths [B] int32, lm [H, V] f32 or null
// (lm_order 0 / 2 / 3), state in/out: [4, B, W] int32 (last, last2,
// hash1, hash2) and [2, B, W] f32 (p_b, p_nb); parents/chars [T, B, W]
// int32. 1 <= W <= 32, V <= 16384.
UASR_EXPORT int uasr_ctc_beam(const float* logp, const int* lengths, const float* lm,
                              int lm_order, float lm_weight, float lm_bonus, int T, int B,
                              int V, int W, int blank, const int* istate_in,
                              const float* fstate_in, int* parents, int* chars,
                              int* istate_out, float* fstate_out, void* stream, int device) {
  const Args a{logp,      lengths,    lm,      lm_order, lm_weight,  lm_bonus, T,
               B,         V,          W,       blank,    istate_in,  fstate_in, parents,
               chars,     istate_out, fstate_out, nullptr};
  return run<false>(a, stream, device);
}

// The same with the phase stamps: phases [B, NPHASES] int64, thread 0's
// clock64() cycles per phase summed over the utterance's steps (row load,
// stays, candidate pass, merges, fix-up and rebuild, barrier waits).
UASR_EXPORT int uasr_ctc_beam_phases(const float* logp, const int* lengths, const float* lm,
                                     int lm_order, float lm_weight, float lm_bonus, int T, int B,
                                     int V, int W, int blank, const int* istate_in,
                                     const float* fstate_in, int* parents, int* chars,
                                     int* istate_out, float* fstate_out, long long* phases,
                                     void* stream, int device) {
  const Args a{logp,      lengths,    lm,      lm_order, lm_weight,  lm_bonus, T,
               B,         V,          W,       blank,    istate_in,  fstate_in, parents,
               chars,     istate_out, fstate_out, phases};
  return run<true>(a, stream, device);
}

// The launch plan for W beams over V symbols: warps per CTA, CTAs per
// utterance (a cluster when 2).
UASR_EXPORT void uasr_ctc_beam_plan(int W, int V, int* warps, int* ctas) {
  plan(W, V, warps, ctas);
}
