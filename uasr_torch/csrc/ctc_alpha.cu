// K3: CTC alpha recursion for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/ops/pallas_ctc.py::_fwd_kernel (reached
// through ctc_loss_pallas -> _ctc_ll -> _ctc_fwd).
//
// Inputs: emit [T, B, S] f32 (log p of the extended label z_s at frame
// t), act [T, B] f32 (1 = frame active), skip_neg and svalid_neg [B, S]
// f32 additive masks (0 or -1e5). Output alpha_traj [T, B, S] f32, the
// alpha of every step. Starting from the virtual seed alpha_{-1} = [0,
// NEG, ...], each step is
//   new   = lse3(alpha[s], alpha[s-1], alpha[s-2] + skip[s]) + emit[t, s]
//   new   = max(new + svalid[s], NEG)
//   alpha = act[t] * new + (1 - act[t]) * alpha
// with shifted-in values NEG and lse3's max floored at NEG, as the TPU
// kernel does. Log-zero is the finite -1e5; nothing is ever -inf.
//
// Design: one CTA per utterance, its S states spread over the threads
// (thread s owns states s, s + blockDim, ...; S = 513 on the main path
// takes 544 threads, one state each). A thread keeps its own alpha in a
// register; the s-1 and s-2 neighbours come through a double-buffered
// row in shared memory, so a step costs one __syncthreads. emit[t + 1]
// and act[t + 1] are loaded one step ahead; emit rows are read and
// alpha rows written coalesced over s. The whole T loop runs inside the
// kernel.
//
// Bound: the bytes are emit in and alpha_traj out (26 MB each at T = 400,
// B = 32, S = 513, ~0.016 ms at 3.35 TB/s), but the T steps form a chain
// and only B CTAs exist, so latency (a shared-memory round trip, three
// expf and a logf per step) sets the time.

#include "common.cuh"

namespace {

constexpr float NEG = -1e5f;
constexpr int THREADS_MAX = 1024;
constexpr int MAXK = 8;  // states per thread (S <= 8 * 1024)

__global__ void __launch_bounds__(THREADS_MAX)
ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ act,
                 const float* __restrict__ skip, const float* __restrict__ svalid,
                 float* __restrict__ traj, int Tn, int B, int S) {
  extern __shared__ float buf[];  // [2][S] alpha rows
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  float a[MAXK], sk[MAXK], sv[MAXK], e[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int s = tid + k * nt;
    a[k] = sk[k] = sv[k] = e[k] = 0.f;
    if (s < S) {
      a[k] = s == 0 ? 0.f : NEG;  // virtual seed alpha_{-1}
      sk[k] = skip[(size_t)b * S + s];
      sv[k] = svalid[(size_t)b * S + s];
      e[k] = emit[(size_t)b * S + s];
      buf[s] = a[k];
    }
  }
  float mf = act[b];
  __syncthreads();
  for (int t = 0; t < Tn; ++t) {
    const float* cur = buf + (t & 1) * S;
    float* nxt = buf + ((t + 1) & 1) * S;
    // next step's inputs, loaded ahead
    float en[MAXK];
    const bool more = t + 1 < Tn;
    const float mf_next = more ? act[(size_t)(t + 1) * B + b] : 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int s = tid + k * nt;
      en[k] = (more && s < S) ? emit[((size_t)(t + 1) * B + b) * S + s] : 0.f;
    }
    float* row = traj + ((size_t)t * B + b) * S;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int s = tid + k * nt;
      if (s < S) {
        const float a0 = a[k];
        const float a1 = s >= 1 ? cur[s - 1] : NEG;
        const float a2 = (s >= 2 ? cur[s - 2] : NEG) + sk[k];
        float m = fmaxf(fmaxf(a0, a1), a2);
        m = fmaxf(m, NEG);
        float nw = m + logf(expf(a0 - m) + expf(a1 - m) + expf(a2 - m));
        nw = nw + e[k];
        nw = fmaxf(nw + sv[k], NEG);
        a[k] = mf * nw + (1.f - mf) * a0;
        nxt[s] = a[k];
        row[s] = a[k];
      }
    }
#pragma unroll
    for (int k = 0; k < MAXK; ++k) e[k] = en[k];
    mf = mf_next;
    __syncthreads();
  }
}

}  // namespace

// emit [T, B, S], act [T, B], skip_neg / svalid_neg [B, S], alpha_traj
// [T, B, S], all f32 and contiguous. S <= 8192.
UASR_EXPORT int uasr_ctc_alpha(const float* emit, const float* act, const float* skip,
                               const float* svalid, float* traj, int T, int B, int S,
                               void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || S < 1 || S > MAXK * THREADS_MAX) return cudaErrorInvalidValue;
  const int threads = min(THREADS_MAX, (S + 31) / 32 * 32);
  if ((S + threads - 1) / threads > MAXK) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  e = uasr_set_smem(ctc_alpha_kernel, smem);
  if (e != cudaSuccess) return e;
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      emit, act, skip, svalid, traj, T, B, S);
  return cudaGetLastError();
}
