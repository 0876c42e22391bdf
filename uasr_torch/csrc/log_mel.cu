// K1: fused log-mel frontend, and K7: the unfused log-mel of the
// streaming frontend, for Hopper (sm_90a).
//
// K1 replaces the TPU kernel uasr/frontend/pallas_frontend.py::
// _log_mel_fused_kernel (reached through _pallas_log_mel(fused=True)).
// Raw audio [B, L] f32 -> [B, T, M (+1)] f32 log-mel. Per frame s = f*FS:
//   DFT_k = x[s : s+FL] @ pre_cos[:, k] + x[s-1] * pre_bvec[0, k]
//   (sin likewise), power = (re^2 + im^2) / n_fft,
//   mel = power @ mel_fb, out = log(max(mel, f64 eps)),
// where pre_cos/pre_sin/pre_bvec fold pre-emphasis and the window into
// the DFT bases (uasr_torch/frontend/features.py::make_frontend_state),
// x[-1] = 0, and sample indices clamp at L-1 (features.frame_audio), so
// audio shorter than one frame still yields one frame.
//
// K7 replaces pallas_frontend.py::_log_mel_kernel (_pallas_log_mel with
// fused=False, which the streaming frontend calls once per chunk on a
// pre-emphasised glued chunk of (FL - FS) + chunk samples). The input is
// already pre-emphasised and the kernel multiplies the window in itself:
//   w = x[s : s+FL] * window,  DFT_k = w @ cos[:, k]  (sin likewise),
// then power, mel and log as K1. The tiers split the WINDOWED frame w.
//
// Arithmetic (every tier, both kernels): each re / im of (frame, bin) is
// one fmaf chain over j = 0 .. FL-1 in ascending order from +0; K1 then
// adds __fmul_rn(x[s-1], bvec) with __fadd_rn; power is
// __fmul_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(q, q)), 1 / n_fft); each
// mel output is one fmaf chain over ascending bins; the log-energy column
// sums all bins in order. Only the schedule below is chosen for speed, so
// the outputs do not depend on it.
//
// Tiers (FrontendConfig.precision, pallas_frontend.py::_dot_tier):
//   highest  plain f32 products, f32 accumulation, no TF32;
//   high     a = ah + al, b = bh + bl (bf16 parts), three products in
//            three accumulators summed (ah@bh + ah@bl) + al@bh;
//   bfloat16 bf16(a) * bf16(b), f32 accumulation.
//
// Bound: at B=32 x 16 s the DFT is ~21 GFLOP against ~33 MB of audio and
// output, so the kernel is bound by f32 FMAs on the CUDA cores (the
// "highest" tier's order rules out the tensor cores). The design is a
// register-tiled CUDA-core GEMM, frames x [cos | sin]:
//   * one CTA of WR x 4 warps per (utterance, tile of FT = 4 WR R frames)
//     covers every bin, in passes of 256: warp (wr, wc) and lane (fl, bl)
//     own frames 4 WR i + 4 wr + fl (i < R) and bins 64 wc + 4 bl + c, +32
//     (c < 4) of the pass, re and im in registers (R = 8, or 4 where larger
//     tiles would leave SMs idle; 2 for "high", whose three accumulators
//     would not fit; WR = 1 halves the tile again). A frame's next four samples are one 128-bit shared load
//     that serves 4 frames (broadcast to 8 lanes each) and feeds 64 FMAs a
//     lane; four 128-bit loads bring a sample's 8 + 8 basis values for 16 R;
//   * the bases, packed once in the slabs' layout (features.pack_bases),
//     stream from L2 in slabs of JS rows (16-byte cp.async) through a
//     3-stage ring while the previous slab is multiplied; rows past FL are
//     zero, so a padded chain adds exact zeros;
//   * NB = 4 n + t: the last t (< 4) bins are the "tail": their bases are
//     staged once, and after the tiles one thread runs each (frame, tail
//     bin) chain;
//   * the audio is staged with cp.async in the first slab's group: K1 the
//     tile's span once (frames overlap in it) when FS is a multiple of 4,
//     else each frame; K7 each frame and the window, multiplied in shared
//     memory (as are the tiers' bf16 parts) after the group lands;
//   * power stays in shared memory (over the ring when one pass covers the
//     bins), and the mel product runs over each filter's nonzero run
//     [lo, hi) only (mel_runs, mel_w: features.make_frontend_state): every
//     partial sum is >= 0 and fmaf(p, 0, s) == s, so skipping the zeros
//     changes no bit.
// The launch plan (R, WR, JS, shared bytes) comes from the wrapper
// (cuda_frontend.launch_plan), which make_plan below mirrors; a mismatch is
// refused.

#include "common.cuh"

namespace {

enum { HIGHEST = 0, HIGH = 1, BF16 = 2 };
enum { PH_STAGE, PH_DFT, PH_POWER, PH_MEL, PH_STORES, NPHASES };
constexpr float LOG_FLOOR = 2.220446049250313e-16f;  // float64 eps
constexpr int BW = 256;       // bins of one pass: 32 lanes x 8
constexpr int STAGES = 3;     // slabs in the basis ring
constexpr size_t MAX_SMEM = 232448;

// Shared-memory layout in floats; cuda_frontend.launch_plan computes the same.
struct Plan {
  int FT, NS, FLP, npass, nt, NBM, PWS, XR, SK, xlen, SF;
  bool span, alias;
  size_t pw_off, xs_off, xl_off, win_off, tail_off, bnd_off, total;
};

__host__ __device__ inline Plan make_plan(int tier, bool unfused, int FL, int FS, int NB, int R,
                                          int WR, int JS) {
  Plan p;
  p.FT = 4 * WR * R;
  p.NS = (FL + JS - 1) / JS;                      // slabs a pass
  p.FLP = (FL + 15) / 16 * 16;                    // rows of the packed bases
  p.nt = NB % 4;                                  // tail bins
  p.NBM = NB - p.nt;                              // bins of the register tiles
  p.npass = p.NBM > 0 ? (p.NBM + BW - 1) / BW : 1;
  p.PWS = (NB + 3) / 4 * 4;                       // power row stride
  p.span = !unfused && FS % 4 == 0 && FS >= JS;
  const int jl = p.NS * JS;                       // samples a frame's chain reads
  // four consecutive frames start in four different 16-byte bank groups:
  // staged frame rows of XR (XR / 4 odd), or the span with SK more floats
  // after every FS samples ((FS + SK) / 4 odd)
  p.XR = jl + ((jl / 4) % 2 == 0 ? 4 : 0);
  p.SK = (FS / 4) % 2 == 0 ? 4 : 0;
  const int n = (p.FT - 1) * FS + jl;
  p.xlen = p.span ? (n + p.SK * ((n - 1) / FS) + 3) / 4 * 4 : p.FT * p.XR;
  p.SF = JS * 2 * BW;                             // one slab: [JS][cos 256 | sin 256]
  const size_t ring = (size_t)STAGES * p.SF, pw = (size_t)p.FT * p.PWS;
  p.alias = p.npass == 1 && pw <= ring;
  p.pw_off = p.alias ? 0 : ring;
  p.xs_off = ring + (p.alias ? 0 : pw);
  p.xl_off = p.xs_off + p.xlen;
  p.win_off = p.xl_off + (tier == HIGH ? p.xlen : 0);
  p.tail_off = p.win_off + (unfused ? jl : 0);    // [cos | sin][nt][FLP]
  p.bnd_off = p.tail_off + 2 * p.nt * p.FLP;
  p.total = p.bnd_off + (p.FT + 3) / 4 * 4;
  return p;
}

struct Args {
  const float* audio;
  long L;
  int T, ntiles;
  const float* pack;    // K1 pre_pack, K7 dft_pack (features.pack_bases)
  const float* bvec;    // K1 [2, NB]
  const float* window;  // K7 [FL]
  const int* runs;      // [3, M]: lo, hi, offset into mel_w
  const float* mel_w;   // each filter's run [lo, hi) of mel_fb, packed
  float* out;
  int FL, FS, NB, M;
  float inv_nfft;
  int want_energy, R, WR, JS;
  long long* phases;    // [gridDim.x, NPHASES] (stamped builds)
};

// sample index clamped to the last sample (features.frame_audio)
__device__ __forceinline__ long clamp_last(long i, long L) { return i < L ? i : L - 1; }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage one value at xs[i] (xl[i] the lo part for "high").
template <int TIER>
__device__ __forceinline__ void stage(float* xs, float* xl, int i, float v) {
  if (TIER == HIGHEST) {
    xs[i] = v;
  } else {
    const float h = bf16_round(v);
    xs[i] = h;
    if (TIER == HIGH) xl[i] = bf16_round(v - h);
  }
}

// A basis value's parts at the tier: h (the only one for "highest" and
// "bfloat16") and l ("high": bf16 of the remainder).
template <int TIER>
__device__ __forceinline__ void split(float v, float& h, float& l) {
  h = TIER == HIGHEST ? v : bf16_round(v);
  l = TIER == HIGH ? bf16_round(v - h) : 0.f;
}

// One sample of one output's chain: x (hi) and xo (lo, "high") against the
// basis parts h, l; "high" keeps its three products in three accumulators.
template <int NACC>
__device__ __forceinline__ void mac(float (&acc)[NACC], float x, float xo, float h, float l) {
  acc[0] = fmaf(x, h, acc[0]);
  if constexpr (NACC == 3) {
    acc[1] = fmaf(x, l, acc[1]);
    acc[2] = fmaf(xo, h, acc[2]);
  }
}

template <int TIER, bool UNFUSED, bool PHASES, int R, int WR>
__global__ void __launch_bounds__(128 * WR, WR == 2 && R >= 8 ? 1 : 2)
    log_mel_kernel(const Args a) {
  constexpr int NACC = TIER == HIGH ? 3 : 1;
  constexpr int THREADS = 128 * WR;
  long long ph[NPHASES] = {}, t_prev = PHASES ? clock64() : 0;
  auto stamp = [&](int q) {
    if constexpr (PHASES) {
      const long long t = clock64();
      ph[q] += t - t_prev;
      t_prev = t;
    }
  };
  const Plan p = make_plan(TIER, UNFUSED, a.FL, a.FS, a.NB, R, WR, a.JS);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* pw = smem + p.pw_off;    // [FT, PWS] power
  float* xs = smem + p.xs_off;    // staged frames (hi, or the only part)
  float* xl = smem + p.xl_off;    // lo part ("high")
  float* win = smem + p.win_off;  // the window (K7)
  float* tl = smem + p.tail_off;  // the tail bins' bases
  float* bnd = smem + p.bnd_off;  // [FT] raw x[s-1] (K1)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long b = blockIdx.x / a.ntiles;
  const int f0 = (int)(blockIdx.x - b * a.ntiles) * p.FT;
  const int nf = min(p.FT, a.T - f0);
  const float* au = a.audio + (size_t)b * a.L;
  const long s0 = (long)f0 * a.FS;
  const int JS = a.JS, total = p.npass * p.NS;

  // slab g (pass g / NS, rows (g % NS) * JS ..) into ring stage g % STAGES:
  // [JS][cos 256 | sin 256] of the packed bases
  auto issue = [&](int g) {
    if (g < total) {
      const int pass = g / p.NS, j0 = (g - pass * p.NS) * JS;
      float* st = ring + (size_t)(g % STAGES) * p.SF;
      const float* src = a.pack + ((size_t)pass * p.FLP + j0) * 2 * BW;
      for (int e = tid; e < JS * 2 * BW / 4; e += THREADS) cp_async16(st + 4 * e, src + 4 * e, true);
    }
    cp_commit();
  };

  // the raw frames (and K7's window) land with the first slab
  if (p.span) {
    const int n = (p.FT - 1) * a.FS + p.NS * JS;
    for (int i = tid; i < n; i += THREADS)
      cp_async4(xs + i + p.SK * (i / a.FS), au + clamp_last(s0 + i, a.L));
  } else {
    for (int i = tid; i < p.xlen; i += THREADS) {
      const int f = i / p.XR, j = i - f * p.XR;
      if (j < a.FL) {
        cp_async4(xs + i, au + clamp_last(s0 + (long)f * a.FS + j, a.L));
      } else {
        xs[i] = 0.f;
      }
    }
  }
  // the tail bins' bases, [cos | sin][nt][FLP] of the pack's [cos | sin][4][FLP]
  for (int e = tid; e < 2 * p.nt * p.FLP / 4; e += THREADS) {
    const int row = e / (p.FLP / 4), w = row / p.nt, t = row - w * p.nt;
    cp_async16(tl + 4 * e,
               a.pack + (size_t)p.npass * p.FLP * 2 * BW + (size_t)(4 * w + t) * p.FLP +
                   4 * (e - row * (p.FLP / 4)),
               true);
  }
  if (UNFUSED) {
    for (int j = tid; j < a.FL; j += THREADS) cp_async4(win + j, a.window + j);
  } else {
    for (int f = tid; f < p.FT; f += THREADS) {
      const long s = s0 + (long)f * a.FS - 1;
      bnd[f] = s < 0 ? 0.f : au[clamp_last(s, a.L)];
    }
  }
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) issue(g);
  stamp(PH_STAGE);

  // warp (wr, wc) and lane (fl, bl): frames 4 WR i + 4 wr + fl (i < R), bins
  // pass * 256 + 64 wc + 4 bl + c and + 32 (c < 4); a 128-bit load then
  // serves 4 frames or 8 bin groups, each broadcast to the other lanes
  const int wr = warp >> 2, wc = warp & 3, fl = lane >> 3, bl = lane & 7;
  const int frame0 = 4 * wr + fl;
  const int xstride = p.span ? a.FS + p.SK : p.XR;  // frame f at xs[f * xstride + j']
  const int fstep = 4 * WR * xstride;              // from frame f to f + 4 WR
  const int kb = 64 * wc + 4 * bl;                 // the lane's first bin in a pass

  float re[R][8][NACC], im[R][8][NACC];
  auto zero = [&]() {
#pragma unroll
    for (int s = 0; s < NACC; ++s) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) re[i][c][s] = im[i][c][s] = 0.f;
    }
  };
  zero();
  auto power = [&](const float (&rs)[NACC], const float (&qs)[NACC], int f, int k) {
    float r = rs[0], q = qs[0];
    if constexpr (TIER == HIGH) {
      r = __fadd_rn(__fadd_rn(r, rs[1]), rs[2]);
      q = __fadd_rn(__fadd_rn(q, qs[1]), qs[2]);
    }
    if (!UNFUSED) {
      r = __fadd_rn(r, __fmul_rn(bnd[f], __ldg(a.bvec + k)));
      q = __fadd_rn(q, __fmul_rn(bnd[f], __ldg(a.bvec + a.NB + k)));
    }
    pw[f * p.PWS + k] = __fmul_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(q, q)), a.inv_nfft);
  };

  for (int g = 0; g < total; ++g) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // slab g landed everywhere; stage (g - 1) % STAGES is free
    issue(g + STAGES - 1);
    if ((UNFUSED || TIER != HIGHEST) && g == 0) {
      // K7's window, and the tiers' bf16 parts, on the staged frames;
      // rounded product (no contraction into the hi/lo split)
      for (int i = tid; i < p.xlen; i += THREADS) {
        const int j = p.span ? 0 : i % p.XR;
        float v = 0.f;
        if (p.span || j < a.FL) v = UNFUSED ? __fmul_rn(xs[i], win[j]) : xs[i];
        stage<TIER>(xs, xl, i, v);
      }
      __syncthreads();
      stamp(PH_STAGE);
    }
    const int pass = g / p.NS, j0 = (g - pass * p.NS) * JS;
    const float* st = ring + (size_t)(g % STAGES) * p.SF;
    // sample j of a frame sits at j + SK * (j / FS) in the span; a slab
    // (JS <= FS rows) crosses at most one multiple of FS
    const int jb = p.span ? j0 / a.FS : 0;
    const int jsplit = p.span ? (jb + 1) * a.FS - j0 : JS;
    const float* xw = xs + frame0 * xstride + j0 + p.SK * jb;
    const float* xwl = xl + frame0 * xstride + j0 + p.SK * jb;
    for (int q = 0; q < JS; q += 4) {
      const int qo = q + (q >= jsplit ? p.SK : 0);
      // the next four samples of each of the lane's frames
      float4 xv[R], xo[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        xv[i] = ld4(xw + i * fstep + qo);
        xo[i] = TIER == HIGH ? ld4(xwl + i * fstep + qo) : xv[i];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* row = st + (q + jj) * 2 * BW + kb;
        const float4 b4[4] = {ld4(row), ld4(row + 32), ld4(row + BW), ld4(row + BW + 32)};
        float ch[8], cl[8], sh[8], sl[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          split<TIER>(comp(b4[c >> 2], c & 3), ch[c], cl[c]);
          split<TIER>(comp(b4[2 + (c >> 2)], c & 3), sh[c], sl[c]);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float x = comp(xv[i], jj), x_lo = comp(xo[i], jj);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            mac<NACC>(re[i][c], x, x_lo, ch[c], cl[c]);
            mac<NACC>(im[i][c], x, x_lo, sh[c], sl[c]);
          }
        }
      }
    }
    if (g - pass * p.NS == p.NS - 1) {  // the pass's last slab: its power
      stamp(PH_DFT);
      if (p.alias) __syncthreads();  // every warp is done with the ring
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = pass * BW + kb + (c >> 2) * 32 + (c & 3);
          if (k < p.NBM) power(re[i][c], im[i][c], 4 * WR * i + frame0, k);
        }
      }
      zero();
      stamp(PH_POWER);
    }
  }
  // the tail bins: one thread a (frame, bin) chain over the staged frames
  for (int it = tid; it < p.FT * p.nt; it += THREADS) {
    const int f = it % p.FT, t = it / p.FT;
    const float *tc = tl + t * p.FLP, *ts = tl + (p.nt + t) * p.FLP;
    float tre[NACC] = {}, tim[NACC] = {};
    int skew = 0, next = a.FS;  // the span's skew before sample j
#pragma unroll 4
    for (int j = 0; j < p.NS * JS; j += 4) {
      if (p.span && j == next) skew += p.SK, next += a.FS;
      const float4 x4 = ld4(xs + f * xstride + j + skew);
      const float4 xl4 = TIER == HIGH ? ld4(xl + f * xstride + j + skew) : x4;
      const float4 c4 = ld4(tc + j), s4 = ld4(ts + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float h, l;
        split<TIER>(comp(c4, jj), h, l);
        mac<NACC>(tre, comp(x4, jj), comp(xl4, jj), h, l);
        split<TIER>(comp(s4, jj), h, l);
        mac<NACC>(tim, comp(x4, jj), comp(xl4, jj), h, l);
      }
    }
    power(tre, tim, f, p.NBM + t);
  }
  __syncthreads();
  stamp(PH_POWER);

  const int Mo = a.M + (a.want_energy ? 1 : 0);
  float* o = a.out + ((size_t)b * a.T + f0) * Mo;
  // thread (m, q) runs filter m's chains for frames q, q + MQ, ..., four
  // side by side (each in ascending bins), its run's bounds loaded once
  const int MQ = max(1, THREADS / a.M);
  for (int idx = tid; idx < a.M * MQ; idx += THREADS) {
    const int m = idx % a.M, q = idx / a.M;
    const int lo = __ldg(a.runs + m), len = __ldg(a.runs + a.M + m) - lo;
    const float* w = a.mel_w + __ldg(a.runs + 2 * a.M + m);
    for (int fq = q; fq < nf; fq += 4 * MQ) {
      const float* prow = pw + fq * p.PWS + lo;
      float s1[4] = {}, s2[4] = {}, s3[4] = {};
      for (int k = 0; k < len; ++k) {
        const float y = __ldg(w + k);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (fq + u * MQ < nf) {
            const float x = prow[u * MQ * p.PWS + k];
            if (TIER == HIGHEST) {
              s1[u] = fmaf(x, y, s1[u]);
            } else {
              const float xh = bf16_round(x), yh = bf16_round(y);
              s1[u] = fmaf(xh, yh, s1[u]);
              if (TIER == HIGH) {
                s2[u] = fmaf(xh, bf16_round(y - yh), s2[u]);
                s3[u] = fmaf(bf16_round(x - xh), yh, s3[u]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = fq + u * MQ;
        const float acc = TIER == HIGH ? __fadd_rn(__fadd_rn(s1[u], s2[u]), s3[u]) : s1[u];
        if (f < nf) o[(size_t)f * Mo + m] = logf(fmaxf(acc, LOG_FLOOR));
      }
    }
  }
  stamp(PH_MEL);
  if (a.want_energy) {
    for (int f = tid; f < nf; f += THREADS) {
      float e = 0.f;
#pragma unroll 8
      for (int k = 0; k < a.NB; ++k) e = __fadd_rn(e, pw[f * p.PWS + k]);
      o[(size_t)f * Mo + a.M] = logf(fmaxf(e, LOG_FLOOR));
    }
  }
  stamp(PH_STORES);
  if constexpr (PHASES) {
    if (tid == 0) {
      for (int q = 0; q < NPHASES; ++q) a.phases[(size_t)blockIdx.x * NPHASES + q] = ph[q];
    }
  }
}

template <int TIER, bool UNFUSED, bool PHASES, int R, int WR>
cudaError_t launch(Args a, long B, size_t smem_bytes, cudaStream_t stream) {
  const Plan p = make_plan(TIER, UNFUSED, a.FL, a.FS, a.NB, R, WR, a.JS);
  const size_t smem = p.total * sizeof(float);
  a.ntiles = (a.T + p.FT - 1) / p.FT;
  const long ctas = B * a.ntiles;
  if (smem != smem_bytes || smem > MAX_SMEM || ctas > 0x7fffffffL) return cudaErrorInvalidValue;
  auto kernel = log_mel_kernel<TIER, UNFUSED, PHASES, R, WR>;
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)ctas, 128 * WR, smem, stream>>>(a);
  return cudaGetLastError();
}

// the tiles (R frames a thread, WR warp rows) each tier is built for;
// cuda_frontend.TILES lists the same
template <bool UNFUSED, bool PHASES>
int dispatch(Args a, long B, int tier, size_t smem, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (a.T < 1 || a.L < 1 || B < 1 || a.JS < 4 || a.JS % 4 || a.FL < 1 || a.FS < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = a.R * 10 + a.WR;
  if (tier == HIGHEST && tile == 82) return launch<HIGHEST, UNFUSED, PHASES, 8, 2>(a, B, smem, s);
  if (tier == HIGHEST && tile == 42) return launch<HIGHEST, UNFUSED, PHASES, 4, 2>(a, B, smem, s);
  if (tier == HIGHEST && tile == 41) return launch<HIGHEST, UNFUSED, PHASES, 4, 1>(a, B, smem, s);
  if (tier == BF16 && tile == 82) return launch<BF16, UNFUSED, PHASES, 8, 2>(a, B, smem, s);
  if (tier == BF16 && tile == 42) return launch<BF16, UNFUSED, PHASES, 4, 2>(a, B, smem, s);
  if (tier == BF16 && tile == 41) return launch<BF16, UNFUSED, PHASES, 4, 1>(a, B, smem, s);
  if (tier == HIGH && tile == 22) return launch<HIGH, UNFUSED, PHASES, 2, 2>(a, B, smem, s);
  return cudaErrorInvalidValue;
}

Args make_args(const float* audio, long L, long T, const float* pack, const float* bvec,
               const float* window, const int* runs, const float* mel_w, float* out, int FL,
               int FS, int NB, int M, float inv_nfft, int want_energy, int R, int WR, int JS,
               long long* phases) {
  return Args{audio, L,  (int)T, 0,        pack,        bvec, window, runs, mel_w, out,
              FL,    FS, NB,     M, inv_nfft, want_energy, R,    WR,     JS, phases};
}

}  // namespace

// K1. audio [B, L] raw, pre_pack (features.pack_bases of pre_cos, pre_sin),
// bvec [2, NB], mel_runs [3, M] int32 and mel_w (features.make_frontend_state),
// out [B, T, M + want_energy]; all contiguous, on `device`. R, WR, JS and
// smem_bytes are the wrapper's launch plan.
UASR_EXPORT int uasr_log_mel(const float* audio, long B, long L, long T, const float* pre_pack,
                             const float* bvec, const int* mel_runs, const float* mel_w,
                             float* out, int FL, int FS, int NB, int M, float inv_nfft, int tier,
                             int want_energy, int R, int WR, int JS, long smem_bytes, void* stream,
                             int device) {
  return dispatch<false, false>(make_args(audio, L, T, pre_pack, bvec, nullptr, mel_runs, mel_w,
                                          out, FL, FS, NB, M, inv_nfft, want_energy, R, WR, JS,
                                          nullptr),
                                B, tier, (size_t)smem_bytes, stream, device);
}

// K1 with phase stamps: phases [B * ceil(T / FT), 5] int64, thread 0's
// clock64 cycles per phase (staging, DFT, power, mel + log, stores).
UASR_EXPORT int uasr_log_mel_phases(const float* audio, long B, long L, long T,
                                    const float* pre_pack, const float* bvec,
                                    const int* mel_runs, const float* mel_w, float* out, int FL,
                                    int FS, int NB, int M, float inv_nfft, int tier,
                                    int want_energy, int R, int WR, int JS, long smem_bytes,
                                    long long* phases, void* stream, int device) {
  return dispatch<false, true>(make_args(audio, L, T, pre_pack, bvec, nullptr, mel_runs, mel_w,
                                         out, FL, FS, NB, M, inv_nfft, want_energy, R, WR, JS,
                                         phases),
                               B, tier, (size_t)smem_bytes, stream, device);
}

// K7. audio [B, L] pre-emphasised, window [FL], dft_pack (pack_bases of
// cos, sin), the rest as K1.
UASR_EXPORT int uasr_log_mel_unfused(const float* audio, long B, long L, long T,
                                     const float* window, const float* dft_pack,
                                     const int* mel_runs, const float* mel_w, float* out, int FL,
                                     int FS, int NB, int M, float inv_nfft, int tier,
                                     int want_energy, int R, int WR, int JS, long smem_bytes,
                                     void* stream, int device) {
  return dispatch<true, false>(make_args(audio, L, T, dft_pack, nullptr, window, mel_runs, mel_w,
                                         out, FL, FS, NB, M, inv_nfft, want_energy, R, WR, JS,
                                         nullptr),
                               B, tier, (size_t)smem_bytes, stream, device);
}

UASR_EXPORT int uasr_log_mel_unfused_phases(const float* audio, long B, long L, long T,
                                            const float* window, const float* dft_pack,
                                            const int* mel_runs, const float* mel_w, float* out,
                                            int FL, int FS, int NB, int M, float inv_nfft,
                                            int tier, int want_energy, int R, int WR, int JS,
                                            long smem_bytes, long long* phases, void* stream,
                                            int device) {
  return dispatch<true, true>(make_args(audio, L, T, dft_pack, nullptr, window, mel_runs, mel_w,
                                        out, FL, FS, NB, M, inv_nfft, want_energy, R, WR, JS, phases),
                              B, tier, (size_t)smem_bytes, stream, device);
}
