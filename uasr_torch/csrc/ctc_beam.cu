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
// Design: one CTA per utterance, the whole T loop in the kernel. Shared
// memory holds only the log-prob row [V], a fold mark per symbol [V] (bit
// w set: ext(w, c) was folded into a stay) and the beam state, so it
// grows as 8 V bytes (the first version kept all W*V + W candidates there
// and could not launch beyond ~227 KB, e.g. V = 4233 at W = 8). Each
// thread computes ext(w, c) on the fly for its strided share of the
// candidates and keeps a register list of its best W, ordered (score
// desc, index asc); warp shuffles merge the 32 lists of a warp. A CTA has
// NWARPS warps, chosen from W*V: one warp for a small vocabulary (its
// merge gives the top W at once), eight for a large one (warp 0 then
// merges the eight warp lists). That order is total, so the merged head
// is exactly what W rounds of (max, lowest-index argmax) pick as long as
// the picks stay above NEG; below it the rounds re-pick a column already
// taken (their NEG mask ties with it), which a last fix-up reproduces.
// Bound: a chain of T dependent steps of ~W*V/(32*NWARPS) candidate
// evaluations per thread, one or two W-round shuffle merges and three or
// four block barriers; the bytes (log-probs in, backpointers out) are small,
// so latency sets the time.

#include <limits.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr uint32_t HASH_MULT = 2654435761u;  // Knuth multiplicative hash
constexpr uint32_t HASH2_MULT = 40503u;
constexpr uint32_t SENT1 = 0xC0000000u;  // -0x40000000 as a 32-bit pattern
constexpr uint32_t SENT2 = 0xE0000000u;  // -0x20000000
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NWARPS = 8;
constexpr int MAX_W = 32;
constexpr int MAX_V = 16384;  // 8 V bytes of dynamic shared memory = 128 KB
// up to this many extend candidates per step a CTA is one warp: eight
// would leave most threads without a candidate and add the second merge
constexpr int ONE_WARP_MAX_WV = 2048;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, NEG);
  return m <= NEG ? NEG : ms + log1pf(expf(fminf(a, b) - ms));
}

// (score desc, index asc): the order W rounds of (max, lowest index) pick in
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// A thread's best LW candidates, sorted; statically indexed so it stays
// in registers.
template <int LW>
struct TopList {
  float v[LW];
  int i[LW];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < LW; ++k) {
      v[k] = -CUDART_INF_F;
      i[k] = INT_MAX;
    }
  }

  __device__ __forceinline__ void insert(float x, int xi) {
    if (!better(x, xi, v[LW - 1], i[LW - 1])) return;
    bool placed = false;
#pragma unroll
    for (int k = LW - 1; k > 0; --k) {
      if (!placed) {
        if (better(x, xi, v[k - 1], i[k - 1])) {
          v[k] = v[k - 1];
          i[k] = i[k - 1];
        } else {
          v[k] = x;
          i[k] = xi;
          placed = true;
        }
      }
    }
    if (!placed) {
      v[0] = x;
      i[0] = xi;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int k = 0; k < LW - 1; ++k) {
      v[k] = v[k + 1];
      i[k] = i[k + 1];
    }
    v[LW - 1] = -CUDART_INF_F;
    i[LW - 1] = INT_MAX;
  }

  // The warp's best W in order into out_v/out_i (lane 0 writes). Indices
  // are unique, so exactly one lane owns each real head; sentinel heads
  // (INT_MAX) are popped by every lane that shows one, harmlessly.
  __device__ __forceinline__ void warp_merge(int W, float* out_v, int* out_i) {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < W; ++r) {
      float bv = v[0];
      int bi = i[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (i[0] == bi) pop();
      if (lane == 0) {
        out_v[r] = bv;
        out_i[r] = bi;
      }
    }
  }
};

// Beam state and per-step scratch in shared memory (W <= MAX_W).
struct Beams {
  float pb[MAX_W], pnb[MAX_W], tot[MAX_W], st_pb[MAX_W], st_pnb[MAX_W];
  int last[MAX_W], last2[MAX_W];
  uint32_t h1[MAX_W], h2[MAX_W], mmask[MAX_W];
  float top_v[MAX_W];
  int top_i[MAX_W];
  float wl_v[MAX_NWARPS * MAX_W];  // the warp lists (NWARPS > 1)
  int wl_i[MAX_NWARPS * MAX_W];
};

// LM row of beam w (null without an LM)
__device__ __forceinline__ const float* lm_row(const Beams& s, int w, const float* lm,
                                               int lm_order, int V) {
  if (!lm_order) return nullptr;
  int hist = s.last[w] >= 0 ? s.last[w] : V;
  if (lm_order == 3) hist += (s.last2[w] >= 0 ? s.last2[w] : V) * (V + 1);
  return lm + (size_t)hist * V;
}

// ext(w, c) before the fold, for beam w's (last, p_b, total): the TPU
// kernel's arithmetic, LM terms as an unfused multiply-add
__device__ __forceinline__ float ext_value(int c, int lw, float pbw, float totw,
                                           const float* lp, const float* lmr, float lm_weight,
                                           float lm_bonus, int blank) {
  float e = (c == lw ? pbw : totw) + lp[c];
  if (lmr) e = __fadd_rn(__fadd_rn(e, __fmul_rn(lm_weight, lmr[c])), lm_bonus);
  return c == blank ? NEG : e;
}

__device__ __forceinline__ float ext_prefold(const Beams& s, int w, int c, const float* lp,
                                             const float* lm, int lm_order, int V,
                                             float lm_weight, float lm_bonus, int blank) {
  return ext_value(c, s.last[w], s.pb[w], s.tot[w], lp, lm_row(s, w, lm, lm_order, V),
                   lm_weight, lm_bonus, blank);
}

template <int LW, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
ctc_beam_kernel(const float* __restrict__ logp, const int* __restrict__ lengths,
                const float* __restrict__ lm, int lm_order, float lm_weight,
                float lm_bonus, int Tn, int B, int V, int W, int blank,
                const int* __restrict__ istate_in, const float* __restrict__ fstate_in,
                int* __restrict__ parents, int* __restrict__ chars,
                int* __restrict__ istate_out, float* __restrict__ fstate_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lp = reinterpret_cast<float*>(smem_raw);         // [V] log-probs of the step
  uint32_t* fmark = reinterpret_cast<uint32_t*>(lp + V);  // [V] fold marks, bit w
  __shared__ Beams s;
  constexpr int NTHREADS = NWARPS * 32;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int WV = W * V;
  const size_t BW = (size_t)B * W;
  const int Tact = min(max(lengths[b], 0), Tn);
  if (tid < W) {
    const size_t o = (size_t)b * W + tid;
    s.last[tid] = istate_in[o];
    s.last2[tid] = istate_in[BW + o];
    s.h1[tid] = (uint32_t)istate_in[2 * BW + o];
    s.h2[tid] = (uint32_t)istate_in[3 * BW + o];
    s.pb[tid] = fstate_in[o];
    s.pnb[tid] = fstate_in[BW + o];
  }
  for (int c = tid; c < V; c += NTHREADS) fmark[c] = 0u;
  __syncthreads();

  for (int t = 0; t < Tact; ++t) {
    const float* lrow = logp + ((size_t)b * Tn + t) * V;
    for (int c = tid; c < V; c += NTHREADS) lp[c] = lrow[c];
    __syncthreads();

    // ---- warp 0: stays, hash matches, folds, fold marks
    if (warp == 0) {
      const int wp = lane;
      float st_pnb = NEG;
      int cp = -1;
      uint32_t mm = 0u;
      if (wp < W) {
        const float tp = lae(s.pb[wp], s.pnb[wp]);
        s.tot[wp] = tp;
        s.st_pb[wp] = tp + lp[blank];
        cp = s.last[wp];
        st_pnb = cp >= 0 ? s.pnb[wp] + lp[cp] : NEG;
        if (cp >= 0) {
          const uint32_t c1 = (uint32_t)cp;
          for (int w = 0; w < W; ++w)
            if (s.h1[w] * HASH_MULT + (c1 + 1u) == s.h1[wp] &&
                s.h2[w] * HASH2_MULT + (c1 + 7u) == s.h2[wp])
              mm |= 1u << w;
        }
        s.mmask[wp] = mm;
      }
      __syncwarp();
      if (wp < W) {
        // an entry folds into the first beam (in order) it matches only
        uint32_t eff = mm;
        for (int q = 0; q < wp; ++q)
          if (s.last[q] == cp) eff &= ~s.mmask[q];
        float fold = NEG;
        for (int w = 0; w < W; ++w) {
          float contrib = NEG;
          if ((eff >> w) & 1u)
            contrib = ext_prefold(s, w, cp, lp, lm, lm_order, V, lm_weight, lm_bonus, blank);
          fold = w == 0 ? contrib : lae(fold, contrib);
        }
        s.st_pnb[wp] = lae(st_pnb, fold);
        if (mm) atomicOr(&fmark[cp], mm);
      }
    }
    __syncthreads();

    // ---- every thread: its share of the W*V + W candidates
    TopList<LW> top;
    top.clear();
    for (int w = 0; w < W; ++w) {
      const float* lmr = lm_row(s, w, lm, lm_order, V);
      const int lw = s.last[w];
      const float pbw = s.pb[w], totw = s.tot[w];
      for (int c = tid; c < V; c += NTHREADS) {
        float e = ext_value(c, lw, pbw, totw, lp, lmr, lm_weight, lm_bonus, blank);
        if ((fmark[c] >> w) & 1u) e = NEG;
        top.insert(e, w * V + c);
      }
    }
    if (tid < W) top.insert(lae(s.st_pb[tid], s.st_pnb[tid]), WV + tid);
    if constexpr (NWARPS == 1) {
      top.warp_merge(W, s.top_v, s.top_i);
    } else {
      top.warp_merge(W, s.wl_v + warp * W, s.wl_i + warp * W);
      __syncthreads();
      // ---- warp 0: merge the warp lists
      if (warp == 0) {
        top.clear();
        for (int e = lane; e < NWARPS * W; e += 32) top.insert(s.wl_v[e], s.wl_i[e]);
        top.warp_merge(W, s.top_v, s.top_i);
      }
    }

    // ---- warp 0: reproduce the rounds, rebuild
    if (warp == 0) {
      __syncwarp();
      if (lane == 0) {
        // Once a round's best is not above NEG, the NEG written over the
        // columns already taken ties with it, and every later round takes
        // the lowest such column.
        int r0 = 0;
        while (r0 < W && s.top_v[r0] > NEG) ++r0;
        if (r0 < W) {
          int m = (r0 == 0 || s.top_v[r0] == NEG) ? s.top_i[r0] : INT_MAX;
          for (int r = 0; r < r0; ++r) m = min(m, s.top_i[r]);
          for (int r = r0; r < W; ++r) s.top_i[r] = m;
        }
      }
      __syncwarp();
      int n_last = 0, n_last2 = 0, parent = lane, ch = -1;
      uint32_t n_h1 = 0u, n_h2 = 0u;
      float n_pb = 0.f, n_pnb = 0.f;
      if (lane < W) {
        const int col = s.top_i[lane];
        const bool is_ext = col < WV;
        parent = is_ext ? col / V : col - WV;
        ch = is_ext ? col - parent * V : -1;
        n_pb = is_ext ? NEG : s.st_pb[parent];
        if (is_ext) {
          n_pnb = (fmark[ch] >> parent) & 1u
                      ? NEG
                      : ext_prefold(s, parent, ch, lp, lm, lm_order, V, lm_weight, lm_bonus,
                                    blank);
        } else {
          n_pnb = s.st_pnb[parent];
        }
        const uint32_t p_h1 = s.h1[parent], p_h2 = s.h2[parent];
        n_h1 = is_ext ? p_h1 * HASH_MULT + (uint32_t)(ch + 1) : p_h1;
        n_h2 = is_ext ? p_h2 * HASH2_MULT + (uint32_t)(ch + 7) : p_h2;
        n_last = is_ext ? ch : s.last[parent];
        n_last2 = is_ext ? s.last[parent] : s.last2[parent];
        if (lae(n_pb, n_pnb) < 0.5f * NEG) {
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
        const size_t o = ((size_t)t * B + b) * W + lane;
        parents[o] = parent;
        chars[o] = ch;
      }
    }
    __syncthreads();
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
};

template <int LW, int NWARPS>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = uasr_set_smem(ctc_beam_kernel<LW, NWARPS>, smem);
  if (e != cudaSuccess) return e;
  ctc_beam_kernel<LW, NWARPS><<<a.B, NWARPS * 32, smem, stream>>>(
      a.logp, a.lengths, a.lm, a.lm_order, a.lm_weight, a.lm_bonus, a.T, a.B, a.V, a.W, a.blank,
      a.istate_in, a.fstate_in, a.parents, a.chars, a.istate_out, a.fstate_out);
  return cudaGetLastError();
}

template <int NWARPS>
cudaError_t launch_lw(const Args& a, size_t smem, cudaStream_t stream) {
  if (a.W <= 8) return launch<8, NWARPS>(a, smem, stream);
  if (a.W <= 16) return launch<16, NWARPS>(a, smem, stream);
  return launch<32, NWARPS>(a, smem, stream);
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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (W < 1 || W > MAX_W || V < 1 || V > MAX_V || T < 1 || B < 1 || blank < 0 || blank >= V)
    return cudaErrorInvalidValue;
  if ((lm_order != 0) != (lm != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)V * (sizeof(float) + sizeof(uint32_t));
  const Args a{logp, lengths, lm,        lm_order,  lm_weight, lm_bonus,   T,
               B,    V,       W,         blank,     istate_in, fstate_in,  parents,
               chars, istate_out, fstate_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return W * V <= ONE_WARP_MAX_WV ? launch_lw<1>(a, smem, s)
                                  : launch_lw<MAX_NWARPS>(a, smem, s);
}
