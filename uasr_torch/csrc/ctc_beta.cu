// K3-bwd: CTC beta recursion and posterior for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/ops/pallas_ctc.py::_bwd_kernel (reached
// through _ctc_ll's backward rule _ctc_bwd_rule).
//
// Inputs: emit [T, B, S] f32, act [T, B] f32, skip_neg and finals_neg
// [B, S] f32 additive masks, alpha_traj [T, B, S] f32 (K3's output),
// ll [B] and the upstream cotangent g [B], f32. Output demit [T, B, S]
// f32 = d(sum_b g_b * ll_b) / d emit. Starting at beta_{T-1} = finals_neg,
// each reverse step is (be = beta_{t+1} + emit[t+1], shifted-in values NEG)
//   new    = lse3(be[s], be[s+1], be[s+2] + skip[s+2])
//   beta_t = act[t+1] * max(new, NEG) + (1 - act[t+1]) * beta_{t+1}
//   demit[t, s] = exp(max(alpha[t, s] + beta_t[s], 2 NEG) - ll) * act[t] * g
// so inactive steps give zero, and a zero-length row (act all zero) gives
// zero everywhere, as the TPU kernel does.
//
// Design: K3's in reverse. One CTA per utterance, states spread over the
// threads, each thread's beta in a register. What the s+1 and s+2
// neighbours need is be_t = beta_t + emit[t], which the owning thread
// writes into a double-buffered shared row right after it computes
// beta_t, so a step costs one __syncthreads. alpha[t] and emit[t] are
// loaded one step ahead; demit rows are written coalesced over s.
//
// Bound: emit, alpha_traj in and demit out (26 MB each at T = 400, B = 32,
// S = 513, ~0.024 ms at 3.35 TB/s); like K3 it is a chain of T dependent
// steps over B CTAs, so latency sets the time.

#include "common.cuh"

namespace {

constexpr float NEG = -1e5f;
constexpr int THREADS_MAX = 1024;
constexpr int MAXK = 8;  // states per thread (S <= 8 * 1024)

__global__ void __launch_bounds__(THREADS_MAX)
ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ act,
                const float* __restrict__ skip, const float* __restrict__ finals,
                const float* __restrict__ traj, const float* __restrict__ ll,
                const float* __restrict__ g, float* __restrict__ demit, int Tn, int B,
                int S) {
  extern __shared__ float buf[];  // [2][S] rows of be_t = beta_t + emit[t]
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  const float llb = ll[b], gb = g[b];
  float beta[MAXK], sk2[MAXK], al[MAXK], em[MAXK];
  const int t0 = Tn - 1;
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int s = tid + k * nt;
    beta[k] = sk2[k] = al[k] = em[k] = 0.f;
    if (s < S) {
      beta[k] = finals[(size_t)b * S + s];
      if (s + 2 < S) sk2[k] = skip[(size_t)b * S + s + 2];
      al[k] = traj[((size_t)t0 * B + b) * S + s];
      em[k] = emit[((size_t)t0 * B + b) * S + s];
    }
  }
  float mf_t = act[(size_t)t0 * B + b];
  float mf_next = 0.f;  // act[t + 1]
  for (int t = t0; t >= 0; --t) {
    const float* cur = buf + ((t + 1) & 1) * S;  // be_{t+1}
    float* nxt = buf + (t & 1) * S;              // be_t
    float al_n[MAXK], em_n[MAXK];
    const bool more = t > 0;
    const float mf_prev = more ? act[(size_t)(t - 1) * B + b] : 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int s = tid + k * nt;
      const size_t i = ((size_t)(t - 1) * B + b) * S + s;
      al_n[k] = (more && s < S) ? traj[i] : 0.f;
      em_n[k] = (more && s < S) ? emit[i] : 0.f;
    }
    float* row = demit + ((size_t)t * B + b) * S;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int s = tid + k * nt;
      if (s < S) {
        if (t < t0) {
          const float b0 = cur[s];
          const float b1 = s + 1 < S ? cur[s + 1] : NEG;
          const float b2 = s + 2 < S ? cur[s + 2] + sk2[k] : NEG;
          float m = fmaxf(fmaxf(b0, b1), b2);
          m = fmaxf(m, NEG);
          const float nw = m + logf(expf(b0 - m) + expf(b1 - m) + expf(b2 - m));
          beta[k] = mf_next * fmaxf(nw, NEG) + (1.f - mf_next) * beta[k];
        }
        const float gam = expf(fmaxf(al[k] + beta[k], 2.f * NEG) - llb);
        row[s] = gam * mf_t * gb;
        nxt[s] = beta[k] + em[k];
      }
    }
#pragma unroll
    for (int k = 0; k < MAXK; ++k) al[k] = al_n[k], em[k] = em_n[k];
    mf_next = mf_t;
    mf_t = mf_prev;
    __syncthreads();
  }
}

}  // namespace

// emit, alpha_traj, demit [T, B, S]; act [T, B]; skip_neg, finals_neg
// [B, S]; ll, g [B]; all f32 and contiguous. S <= 8192.
UASR_EXPORT int uasr_ctc_beta(const float* emit, const float* act, const float* skip,
                              const float* finals, const float* traj, const float* ll,
                              const float* g, float* demit, int T, int B, int S, void* stream,
                              int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || S < 1 || S > MAXK * THREADS_MAX) return cudaErrorInvalidValue;
  const int threads = min(THREADS_MAX, (S + 31) / 32 * 32);
  if ((S + threads - 1) / threads > MAXK) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  e = uasr_set_smem(ctc_beta_kernel, smem);
  if (e != cudaSuccess) return e;
  ctc_beta_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      emit, act, skip, finals, traj, ll, g, demit, T, B, S);
  return cudaGetLastError();
}
