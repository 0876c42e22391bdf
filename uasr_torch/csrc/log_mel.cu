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
// Design (both): one CTA per (utterance, tile of FT frames; 32, or 8 for
// the three-accumulator "high" tier). K1 stages the tile's audio span
// once in shared memory and reads frames from it as overlapping windows;
// K7 stages the tile's windowed frames [FT, FL] (the window differs per
// position in a frame, so the overlap cannot be shared). The TPU
// kernels' 640-sample stripes and residue transposes existed only for
// lane alignment and are gone. Thread k owns DFT bin k for all FT frames
// (2*FT accumulators in registers) and streams column k of the bases from
// L2, so each basis element loaded feeds 2*FT multiply-adds. Frames and
// power never reach device memory: power lives in shared memory until
// the mel product.
//
// Bound: at B=32 x 16 s the DFT is ~22 GFLOP against ~33 MB of audio and
// output, so the kernel is bound by operations (f32 FMA on CUDA cores for
// the "highest" tier; bf16 operands with f32 accumulation for the others,
// computed here on CUDA cores too: products of bf16 values are exact in
// f32). A streaming chunk (B=64 x 64 frames) is ~1.7 GFLOP. Tensor cores
// (wgmma) are the next step.
//
// Tiers (FrontendConfig.precision, pallas_frontend.py::_dot_tier):
//   highest  plain f32 products, f32 accumulation, no TF32;
//   high     a = ah + al, b = bh + bl (bf16 parts), three products summed
//            as three passes: (ah@bh + ah@bl) + al@bh;
//   bfloat16 bf16(a) * bf16(b), f32 accumulation.

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
enum { HIGHEST = 0, HIGH = 1, BF16 = 2 };
constexpr float LOG_FLOOR = 2.220446049250313e-16f;  // float64 eps

// frames per CTA: the HIGH tier keeps three accumulators per output
template <int TIER>
__host__ __device__ constexpr int frames_per_cta() { return TIER == HIGH ? 8 : 32; }

// sample index clamped to the last sample (features.frame_audio)
__device__ __forceinline__ long clamp_last(long i, long L) { return i < L ? i : L - 1; }

// Tiered product of a [n] row with a strided [n] column. HIGH sums its
// three bf16 products in separate accumulators, (hi*hi + hi*lo) + lo*hi,
// as three passes do (pallas_frontend.py::_dot_tier).
template <int TIER>
__device__ __forceinline__ float tier_dot(const float* a, const float* b, int n, int stride) {
  float s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int k = 0; k < n; ++k) {
    const float x = a[k], y = b[(size_t)k * stride];
    if (TIER == HIGHEST) {
      s1 = fmaf(x, y, s1);
    } else {
      const float xh = bf16_round(x), yh = bf16_round(y);
      s1 = fmaf(xh, yh, s1);
      if (TIER == HIGH) {
        s2 = fmaf(xh, bf16_round(y - yh), s2);
        s3 = fmaf(bf16_round(x - xh), yh, s3);
      }
    }
  }
  return TIER == HIGH ? __fadd_rn(__fadd_rn(s1, s2), s3) : s1;
}

// Staged operand length: K1 the tile's audio span, K7 its windowed frames.
template <int TIER, bool UNFUSED>
__host__ __device__ constexpr int staged_len(int FL, int FS) {
  return UNFUSED ? frames_per_cta<TIER>() * FL : (frames_per_cta<TIER>() - 1) * FS + FL;
}

// pre_cos/pre_sin/bvec: K1's folded bases (window null); K7 passes the
// plain cos/sin bases and the window (bvec null).
template <int TIER, bool UNFUSED>
__global__ void __launch_bounds__(MAX_THREADS)
log_mel_kernel(const float* __restrict__ audio, long L, int T,
               const float* __restrict__ pre_cos, const float* __restrict__ pre_sin,
               const float* __restrict__ bvec, const float* __restrict__ window,
               const float* __restrict__ mel_fb, float* __restrict__ out, int FL, int FS,
               int NB, int M, float inv_nfft, int want_energy) {
  constexpr int FT = frames_per_cta<TIER>();
  constexpr int NACC = TIER == HIGH ? 3 : 1;
  extern __shared__ float smem[];
  const int span = staged_len<TIER, UNFUSED>(FL, FS);
  const int xstride = UNFUSED ? FL : FS;      // frame f starts at xs[f * xstride]
  float* xs = smem;                           // [span] hi (or only) operand
  float* xl = xs + span;                      // [span] lo part, HIGH tier only
  float* pw = xl + (TIER == HIGH ? span : 0); // [FT, NB] power spectrum
  float* bnd = pw + FT * NB;                  // [FT] raw x[s-1] per frame (K1)

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, T - f0);
  const float* a = audio + (size_t)b * L;
  const long s0 = (long)f0 * FS;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    float v;
    if (UNFUSED) {
      const int f = i / FL, j = i - f * FL;
      // rounded product (no contraction into the hi/lo split below)
      v = __fmul_rn(a[clamp_last(s0 + (long)f * FS + j, L)], window[j]);
    } else {
      v = a[clamp_last(s0 + i, L)];
    }
    if (TIER == HIGHEST) {
      xs[i] = v;
    } else {
      const float h = bf16_round(v);
      xs[i] = h;
      if (TIER == HIGH) xl[i] = bf16_round(v - h);
    }
  }
  if (!UNFUSED) {
    for (int f = threadIdx.x; f < FT; f += blockDim.x) {
      const long s = s0 + (long)f * FS - 1;
      bnd[f] = s < 0 ? 0.f : a[clamp_last(s, L)];
    }
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < NB) {
    // re/im accumulators [pass][frame]; pass 0 = hi*hi (or the only one),
    // 1 = hi*lo, 2 = lo*hi
    float re[NACC][FT], im[NACC][FT];
#pragma unroll
    for (int p = 0; p < NACC; ++p) {
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        re[p][f] = 0.f;
        im[p][f] = 0.f;
      }
    }
    for (int j = 0; j < FL; ++j) {
      const float c = pre_cos[(size_t)j * NB + k];
      const float s = pre_sin[(size_t)j * NB + k];
      if (TIER == HIGHEST) {
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const float x = xs[f * xstride + j];
          re[0][f] = fmaf(x, c, re[0][f]);
          im[0][f] = fmaf(x, s, im[0][f]);
        }
      } else {
        const float ch = bf16_round(c), sh = bf16_round(s);
        const float cl = bf16_round(c - ch), sl = bf16_round(s - sh);
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const float xh = xs[f * xstride + j];
          re[0][f] = fmaf(xh, ch, re[0][f]);
          im[0][f] = fmaf(xh, sh, im[0][f]);
          if constexpr (TIER == HIGH) {
            const float xo = xl[f * xstride + j];
            re[1][f] = fmaf(xh, cl, re[1][f]);
            im[1][f] = fmaf(xh, sl, im[1][f]);
            re[2][f] = fmaf(xo, ch, re[2][f]);
            im[2][f] = fmaf(xo, sh, im[2][f]);
          }
        }
      }
    }
    const float b0 = UNFUSED ? 0.f : bvec[k], b1 = UNFUSED ? 0.f : bvec[NB + k];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f < nf) {
        float r = re[0][f], q = im[0][f];
        if constexpr (TIER == HIGH) {
          r = __fadd_rn(__fadd_rn(r, re[1][f]), re[2][f]);
          q = __fadd_rn(__fadd_rn(q, im[1][f]), im[2][f]);
        }
        if (!UNFUSED) {
          r = __fadd_rn(r, __fmul_rn(bnd[f], b0));
          q = __fadd_rn(q, __fmul_rn(bnd[f], b1));
        }
        pw[f * NB + k] = __fmul_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(q, q)), inv_nfft);
      }
    }
  }
  __syncthreads();

  const int Mo = M + (want_energy ? 1 : 0);
  float* o = out + ((size_t)b * T + f0) * Mo;
  for (int i = threadIdx.x; i < nf * M; i += blockDim.x) {
    const int f = i / M, m = i - f * M;
    const float acc = tier_dot<TIER>(pw + f * NB, mel_fb + m, NB, M);
    o[(size_t)f * Mo + m] = logf(fmaxf(acc, LOG_FLOOR));
  }
  if (want_energy) {
    for (int f = threadIdx.x; f < nf; f += blockDim.x) {
      float e = 0.f;
      for (int kk = 0; kk < NB; ++kk) e += pw[f * NB + kk];
      o[(size_t)f * Mo + M] = logf(fmaxf(e, LOG_FLOOR));
    }
  }
}

template <int TIER, bool UNFUSED>
cudaError_t launch(long B, int threads, cudaStream_t stream, const float* audio, long L,
                   int T, const float* cos_b, const float* sin_b, const float* bvec,
                   const float* window, const float* mel_fb, float* out, int FL, int FS,
                   int NB, int M, float inv_nfft, int want_energy) {
  constexpr int FT = frames_per_cta<TIER>();
  const size_t span = (size_t)staged_len<TIER, UNFUSED>(FL, FS);
  const size_t smem = (span * (TIER == HIGH ? 2 : 1) + (size_t)FT * NB + FT) * sizeof(float);
  const dim3 grid((unsigned)((T + FT - 1) / FT), (unsigned)B);
  cudaError_t e = uasr_set_smem(log_mel_kernel<TIER, UNFUSED>, smem);
  if (e != cudaSuccess) return e;
  log_mel_kernel<TIER, UNFUSED><<<grid, threads, smem, stream>>>(
      audio, L, T, cos_b, sin_b, bvec, window, mel_fb, out, FL, FS, NB, M, inv_nfft,
      want_energy);
  return cudaGetLastError();
}

template <bool UNFUSED>
int dispatch(const float* audio, long B, long L, long T, const float* cos_b,
             const float* sin_b, const float* bvec, const float* window, const float* mel_fb,
             float* out, int FL, int FS, int NB, int M, float inv_nfft, int tier,
             int want_energy, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (NB > MAX_THREADS || B > 65535 || T < 1 || L < 1) return cudaErrorInvalidValue;
  const int threads = ((NB + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case HIGHEST:
      return launch<HIGHEST, UNFUSED>(B, threads, s, audio, L, (int)T, cos_b, sin_b, bvec,
                                      window, mel_fb, out, FL, FS, NB, M, inv_nfft,
                                      want_energy);
    case HIGH:
      return launch<HIGH, UNFUSED>(B, threads, s, audio, L, (int)T, cos_b, sin_b, bvec,
                                   window, mel_fb, out, FL, FS, NB, M, inv_nfft, want_energy);
    case BF16:
      return launch<BF16, UNFUSED>(B, threads, s, audio, L, (int)T, cos_b, sin_b, bvec,
                                   window, mel_fb, out, FL, FS, NB, M, inv_nfft, want_energy);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K1. audio [B, L] raw, pre_cos/pre_sin [FL, NB], bvec [2, NB], mel_fb
// [NB, M], out [B, T, M + want_energy]; all f32, contiguous, on `device`.
UASR_EXPORT int uasr_log_mel(const float* audio, long B, long L, long T,
                             const float* pre_cos, const float* pre_sin,
                             const float* bvec, const float* mel_fb, float* out,
                             int FL, int FS, int NB, int M, float inv_nfft,
                             int tier, int want_energy, void* stream, int device) {
  return dispatch<false>(audio, B, L, T, pre_cos, pre_sin, bvec, nullptr, mel_fb, out, FL, FS,
                         NB, M, inv_nfft, tier, want_energy, stream, device);
}

// K7. audio [B, L] pre-emphasised, window [FL], cos/sin [FL, NB], mel_fb
// [NB, M], out [B, T, M + want_energy]; all f32, contiguous, on `device`.
UASR_EXPORT int uasr_log_mel_unfused(const float* audio, long B, long L, long T,
                                     const float* window, const float* cos_b,
                                     const float* sin_b, const float* mel_fb, float* out,
                                     int FL, int FS, int NB, int M, float inv_nfft, int tier,
                                     int want_energy, void* stream, int device) {
  return dispatch<true>(audio, B, L, T, cos_b, sin_b, nullptr, window, mel_fb, out, FL, FS, NB,
                        M, inv_nfft, tier, want_energy, stream, device);
}
