// K4: exact CTC prefix beam search for Hopper (sm_90a).
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
// Inputs: log-softmax [B, T, V] f32, lengths [B] int32, LM table or null.
// Outputs: backpointers parents/chars [T, B, W] int32, final pb/pnb
// [B, W] f32; the traceback runs outside (uasr_torch/ops/cuda_beam.py).
//
// Design: one warp per utterance, the whole T loop in the kernel, beam
// state and the step's W*V + W candidates in shared memory. A step needs
// no block barrier (only __syncwarp); the fold and the top-W reduction run
// on warp ballots and shuffles. Bound: a chain of T dependent steps of
// a few hundred instructions each; bytes (the log-probs in, the
// backpointers out) are tiny, so latency sets the time.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr uint32_t HASH_MULT = 2654435761u;  // Knuth multiplicative hash
constexpr uint32_t HASH2_MULT = 40503u;
constexpr uint32_t SENT1 = 0xC0000000u;  // -0x40000000 as a 32-bit pattern
constexpr uint32_t SENT2 = 0xE0000000u;  // -0x20000000
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, NEG);
  return m <= NEG ? NEG : ms + log1pf(expf(fminf(a, b) - ms));
}

__global__ void __launch_bounds__(32)
ctc_beam_kernel(const float* __restrict__ logp, const int* __restrict__ lengths,
                const float* __restrict__ lm, int lm_order, float lm_weight,
                float lm_bonus, int Tn, int B, int V, int W, int blank,
                int* __restrict__ parents, int* __restrict__ chars,
                float* __restrict__ pb_out, float* __restrict__ pnb_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WV = W * V, K = WV + W;
  float* lp = reinterpret_cast<float*>(smem_raw);  // [V]
  float* ext = lp + V;                             // [W*V]
  float* cand = ext + WV;                          // [K]
  float* pb = cand + K;                            // [W] state
  float* pnb = pb + W;
  float* tot = pnb + W;                            // [W] logaddexp(pb, pnb)
  float* st_pb = tot + W;                          // [W] stay candidates
  float* st_pnb = st_pb + W;
  int* last = reinterpret_cast<int*>(st_pnb + W);  // [W]
  int* last2 = last + W;
  uint32_t* h1 = reinterpret_cast<uint32_t*>(last2 + W);
  uint32_t* h2 = h1 + W;
  int* sel = reinterpret_cast<int*>(h2 + W);       // [W] selected columns

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int len = lengths[b];
  if (lane < W) {
    last[lane] = -1;
    last2[lane] = -1;
    h1[lane] = 0u;
    h2[lane] = 0u;
    pb[lane] = lane == 0 ? 0.f : NEG;
    pnb[lane] = NEG;
  }
  __syncwarp();

  for (int t = 0; t < Tn; ++t) {
    const float* lrow = logp + ((size_t)b * Tn + t) * V;
    for (int c = lane; c < V; c += 32) lp[c] = lrow[c];
    __syncwarp();
    // stay candidates
    if (lane < W) {
      const float tp = lae(pb[lane], pnb[lane]);
      tot[lane] = tp;
      st_pb[lane] = tp + lp[blank];
      const int lw = last[lane];
      st_pnb[lane] = lw >= 0 ? pnb[lane] + lp[lw] : NEG;
    }
    __syncwarp();
    // extend candidates
    for (int i = lane; i < WV; i += 32) {
      const int w = i / V, c = i - w * V;
      float e = (c == last[w] ? pb[w] : tot[w]) + lp[c];
      if (lm_order) {
        int hist = last[w] >= 0 ? last[w] : V;
        if (lm_order == 3) hist += (last2[w] >= 0 ? last2[w] : V) * (V + 1);
        // unfused multiply-add, as the TPU kernel rounds it
        e = __fadd_rn(__fadd_rn(e, __fmul_rn(lm_weight, lm[(size_t)hist * V + c])), lm_bonus);
      }
      ext[i] = c == blank ? NEG : e;
    }
    __syncwarp();
    // fold ext(w, c = last[wp]) into stay(wp) where the prefixes match.
    // The TPU kernel left-folds logaddexp over all W contributions, the
    // unmatched ones being NEG; lae(x, NEG) == max(x, NEG) exactly, so for
    // W >= 2 folding only the matched terms, from NEG, gives the same bits.
    for (int wp = 0; wp < W; ++wp) {
      const int cp = last[wp];
      bool m = false;
      float contrib = NEG;
      if (lane < W && cp >= 0) {
        const uint32_t c1 = (uint32_t)cp;
        m = h1[lane] * HASH_MULT + (c1 + 1u) == h1[wp] &&
            h2[lane] * HASH2_MULT + (c1 + 7u) == h2[wp];
        if (m) {
          contrib = ext[lane * V + cp];
          ext[lane * V + cp] = NEG;
        }
      }
      unsigned hits = __ballot_sync(FULL, m);
      float fold = W == 1 ? __shfl_sync(FULL, contrib, 0) : NEG;
      while (W > 1 && hits) {
        const int w = __ffs(hits) - 1;
        hits &= hits - 1;
        fold = lae(fold, __shfl_sync(FULL, contrib, w));
      }
      if (lane == 0) st_pnb[wp] = lae(st_pnb[wp], fold);
      __syncwarp();
    }
    // candidate totals: ext first, then stays
    for (int i = lane; i < K; i += 32) cand[i] = i < WV ? ext[i] : lae(st_pb[i - WV], st_pnb[i - WV]);
    __syncwarp();
    // top-W: W rounds of (max, lowest-index argmax, mask)
    for (int r = 0; r < W; ++r) {
      float bv = -CUDART_INF_F;
      int bi = K;
      for (int i = lane; i < K; i += 32) {
        const float v = cand[i];
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        sel[r] = bi;
        cand[bi] = NEG;
      }
      __syncwarp();
    }
    // rebuild the selected beams from (parent, char)
    const bool active = t < len;
    int n_last = 0, n_last2 = 0, parent = lane, ch = -1;
    uint32_t n_h1 = 0u, n_h2 = 0u;
    float n_pb = 0.f, n_pnb = 0.f;
    if (lane < W) {
      const int col = sel[lane];
      const bool is_ext = col < WV;
      parent = is_ext ? col / V : col - WV;
      ch = is_ext ? col - parent * V : -1;
      const int p_last = last[parent], p_last2 = last2[parent];
      const uint32_t p_h1 = h1[parent], p_h2 = h2[parent];
      n_pb = is_ext ? NEG : st_pb[parent];
      n_pnb = is_ext ? ext[col] : st_pnb[parent];
      n_h1 = is_ext ? p_h1 * HASH_MULT + (uint32_t)(ch + 1) : p_h1;
      n_h2 = is_ext ? p_h2 * HASH2_MULT + (uint32_t)(ch + 7) : p_h2;
      n_last = is_ext ? ch : p_last;
      n_last2 = is_ext ? p_last : p_last2;
      if (lae(n_pb, n_pnb) < 0.5f * NEG) {
        n_h1 = SENT1 + (uint32_t)lane;
        n_h2 = SENT2 + (uint32_t)lane;
      }
    }
    __syncwarp();
    if (lane < W) {
      const size_t o = ((size_t)t * B + b) * W + lane;
      if (active) {
        last[lane] = n_last;
        last2[lane] = n_last2;
        h1[lane] = n_h1;
        h2[lane] = n_h2;
        pb[lane] = n_pb;
        pnb[lane] = n_pnb;
        parents[o] = parent;
        chars[o] = ch;
      } else {
        parents[o] = lane;
        chars[o] = -1;
      }
    }
    __syncwarp();
  }
  if (lane < W) {
    pb_out[(size_t)b * W + lane] = pb[lane];
    pnb_out[(size_t)b * W + lane] = pnb[lane];
  }
}

}  // namespace

// logp [B, T, V] f32, lengths [B] int32, lm [H, V] f32 or null
// (lm_order 0 / 2 / 3), parents/chars [T, B, W] int32, pb/pnb [B, W] f32.
UASR_EXPORT int uasr_ctc_beam(const float* logp, const int* lengths, const float* lm,
                              int lm_order, float lm_weight, float lm_bonus, int T, int B,
                              int V, int W, int blank, int* parents, int* chars,
                              float* pb, float* pnb, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (W < 1 || W > 32 || V < 1 || T < 1 || B < 1 || blank < 0 || blank >= V)
    return cudaErrorInvalidValue;
  if ((lm_order != 0) != (lm != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(V + W * V + (W * V + W) + 5 * W) * sizeof(float) +
                      (size_t)5 * W * sizeof(int);
  e = uasr_set_smem(ctc_beam_kernel, smem);
  if (e != cudaSuccess) return e;
  ctc_beam_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      logp, lengths, lm, lm_order, lm_weight, lm_bonus, T, B, V, W, blank, parents, chars,
      pb, pnb);
  return cudaGetLastError();
}
