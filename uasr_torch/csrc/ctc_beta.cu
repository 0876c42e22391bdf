// K3-bwd: CTC beta recursion and posterior for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/ops/pallas_ctc.py::_bwd_kernel (reached
// through _ctc_ll's backward rule _ctc_bwd_rule).
//
// Inputs: emit [T, B, S] f32, act [T, B] f32 (any {0, 1} mask), skip_neg
// and finals_neg [B, S] f32 additive masks, alpha_traj [T, B, S] f32 (K3's
// output), ll [B] and the upstream cotangent g [B], f32. Output demit
// [T, B, S] f32 = d(sum_b g_b * ll_b) / d emit. Starting at beta_{T-1} =
// finals_neg, each reverse step is (be = beta_{t+1} + emit[t+1],
// shifted-in values NEG)
//   new    = lse3(be[s], be[s+1], be[s+2] + skip[s+2])
//   beta_t = act[t+1] * max(new, NEG) + (1 - act[t+1]) * beta_{t+1}
//   demit[t, s] = exp(max(alpha[t, s] + beta_t[s], 2 NEG) - ll) * act[t] * g
// so inactive steps give zero, and a zero-length row (act all zero) gives
// zero everywhere, as the TPU kernel does (expf and logf, no fast-math).
//
// Bound: emit, alpha_traj in and demit out (26 MB each at T = 400, B = 32,
// S = 513, ~0.024 ms at 3.35 TB/s); like K3 it is a chain of T dependent
// steps, each on one SM, so the time is T times the time of one step.
//
// Design: K3's in reverse (ctc_alpha.cu). One CTA per utterance, K states
// per thread fixed at compile time, each thread's beta in registers. What
// the s+1 and s+2 neighbours need is be_t = beta_t + emit[t], which the
// owning thread writes into a double-buffered shared row right after it
// computes beta_t, so a step costs one __syncthreads. Each step's alpha
// row, emit row and act value come into a ring of D slots in shared
// memory, D - 1 steps ahead of the chain, by 4-byte cp.async: each thread
// copies and reads only its own states' elements (its own wait orders
// them); thread 0 copies act and waits before the barrier after which
// every thread reads it; act[t + 1] is the last step's act[t], kept in a
// register. A step reads its shared values first and then issues the next
// copy, so the copy's bookkeeping fills the math's latency (K3 issues
// first: each order measured the faster for its kernel). D is 16 unless
// the caller asks for 2, 4 or 8, and halves while the ring does not fit
// shared memory (D = 2 at S = 8192). demit rows are written coalesced
// over s.

#include "common.cuh"

namespace {

constexpr float NEG = -1e5f;
constexpr int THREADS_MAX = 1024;
constexpr int MAXK = 8;  // states per thread (S <= 8 * 1024)
constexpr int DEFAULT_DEPTH = 16;
// phase stamps (uasr_ctc_beta_phases): thread 0's clock64() deltas per
// phase, summed over the steps
enum { PH_ROWS, PH_MATH, PH_BARRIER, PH_STORES, NPHASES };

size_t smem_bytes(int S, int D) { return ((size_t)(2 + 2 * D) * S + D) * sizeof(float); }

template <int K, int D, bool PHASES>
__global__ void __launch_bounds__(THREADS_MAX)
ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ act,
                const float* __restrict__ skip, const float* __restrict__ finals,
                const float* __restrict__ traj, const float* __restrict__ ll,
                const float* __restrict__ g, float* __restrict__ demit, int Tn, int B,
                int S, long long* __restrict__ phases) {
  extern __shared__ float smem[];
  // [2][S] rows of be_t = beta_t + emit[t], then the ring: [D][S] alpha
  // rows, [D][S] emit rows, [D] act values
  float* cur = smem;      // be_{t+1}
  float* nxt = smem + S;  // be_t
  const float* ring_al = smem + 2 * S;
  const float* ring_em = ring_al + D * S;
  const float* ring_act = ring_em + D * S;
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  const float llb = ll[b], gb = g[b];
  const size_t step = (size_t)B * S;  // one frame of emit, alpha_traj, demit
  const size_t last = (size_t)(Tn - 1) * step + (size_t)b * S + tid;
  bool own[K];                        // state tid + k nt exists
#pragma unroll
  for (int k = 0; k < K; ++k) own[k] = tid + k * nt < S;
  // the ring's next copy: reverse step i (frame T - 1 - i), this thread's
  // alpha and emit elements from asrc and esrc (act from actsrc, thread 0)
  // into slot i % D at shared-space address w (its emit D S floats on, wa
  // for act), carried from copy to copy so no step recomputes them; past
  // the last step an empty group, so the waits count alike
  int i_next = 0;
  const float *asrc = traj + last, *esrc = emit + last;
  const float* actsrc = act + (size_t)(Tn - 1) * B + b;
  uint32_t w = smem_u32(ring_al + tid), wa = smem_u32(ring_act);
  const uint32_t slot_bytes = 4 * S, wrap_bytes = 4 * (D - 1) * S, em_bytes = 4 * D * S;
  auto issue = [&]() {
    if (i_next < Tn) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (own[k]) {
          cp_async4(w + 4 * k * nt, asrc + k * nt);
          cp_async4(w + em_bytes + 4 * k * nt, esrc + k * nt);
        }
      }
      if (tid == 0) cp_async4(wa, actsrc);
      const bool wrap = (i_next & (D - 1)) == D - 1;
      w = wrap ? w - wrap_bytes : w + slot_bytes;
      wa = wrap ? wa - 4 * (D - 1) : wa + 4;
      asrc -= step;
      esrc -= step;
      actsrc -= B;
    }
    ++i_next;
    cp_commit();
  };
  float beta[K], sk2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    beta[k] = sk2[k] = 0.f;
    if (own[k]) {
      beta[k] = finals[(size_t)b * S + s];
      if (s + 2 < S) sk2[k] = skip[(size_t)b * S + s + 2];
    }
  }
  for (int i = 0; i < D - 1; ++i) issue();
  cp_wait<D - 2>();  // the first step's group
  __syncthreads();
  float mf_next = 0.f;  // act[t + 1]
  long long ph[NPHASES] = {}, t_prev = PHASES ? clock64() : 0;
  auto stamp = [&](int p) {
    if constexpr (PHASES) {
      const long long now = clock64();
      ph[p] += now - t_prev;
      t_prev = now;
    }
  };
  float* row = demit + last;
  for (int i = 0; i < Tn; ++i) {
    // the step's shared reads, then the next copy (into slot (i - 1) % D,
    // which every thread read before the last barrier), so the copy's
    // bookkeeping can fill the math's latency
    const float* al = ring_al + (i & (D - 1)) * S;
    const float* em = ring_em + (i & (D - 1)) * S;
    const float mf_t = ring_act[i & (D - 1)];
    float b0[K], b1[K], b2[K], alt[K], emt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      b0[k] = i > 0 && own[k] ? cur[s] : NEG;
      b1[k] = i > 0 && s + 1 < S ? cur[s + 1] : NEG;
      b2[k] = i > 0 && s + 2 < S ? cur[s + 2] : NEG;
      alt[k] = own[k] ? al[s] : 0.f;
      emt[k] = own[k] ? em[s] : 0.f;
    }
    issue();
    stamp(PH_ROWS);
    float d[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      d[k] = 0.f;
      if (own[k]) {
        if (i > 0) {
          const float b2s = s + 2 < S ? b2[k] + sk2[k] : NEG;
          float m = fmaxf(fmaxf(b0[k], b1[k]), b2s);
          m = fmaxf(m, NEG);
          const float nw = m + logf(expf(b0[k] - m) + expf(b1[k] - m) + expf(b2s - m));
          beta[k] = mf_next * fmaxf(nw, NEG) + (1.f - mf_next) * beta[k];
        }
        const float gam = expf(fmaxf(alt[k] + beta[k], 2.f * NEG) - llb);
        d[k] = gam * mf_t * gb;
      }
    }
    stamp(PH_MATH);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (own[k]) {
        row[k * nt] = d[k];
        nxt[tid + k * nt] = beta[k] + emt[k];
      }
    }
    row -= step;
    mf_next = mf_t;
    stamp(PH_STORES);
    cp_wait<D - 2>();  // the next step's group (thread 0: its act too)
    stamp(PH_ROWS);
    __syncthreads();
    stamp(PH_BARRIER);
    float* x = cur;
    cur = nxt;
    nxt = x;
  }
  if constexpr (PHASES) {
    if (tid == 0)
      for (int p = 0; p < NPHASES; ++p) phases[(size_t)b * NPHASES + p] = ph[p];
  }
}

struct Args {
  const float *emit, *act, *skip, *finals, *traj, *ll, *g;
  float* demit;
  int T, B, S;
  long long* phases;
};

// states per thread, threads, ring depth
cudaError_t plan(int S, int depth, int device, int* k, int* threads, int* d) {
  if (S < 1 || S > MAXK * THREADS_MAX) return cudaErrorInvalidValue;
  if (depth == 0) depth = DEFAULT_DEPTH;
  if (depth != 2 && depth != 4 && depth != 8 && depth != 16) return cudaErrorInvalidValue;
  int K = 1;
  while (K * THREADS_MAX < S) K *= 2;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  while (depth > 2 && smem_bytes(S, depth) > (size_t)optin) depth /= 2;
  if (smem_bytes(S, depth) > (size_t)optin) return cudaErrorInvalidValue;
  *k = K;
  *threads = ((S + K - 1) / K + 31) / 32 * 32;
  *d = depth;
  return cudaSuccess;
}

template <int K, int D, bool PHASES>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  auto kernel = ctc_beta_kernel<K, D, PHASES>;
  const size_t smem = smem_bytes(a.S, D);
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.B, threads, smem, stream>>>(a.emit, a.act, a.skip, a.finals, a.traj, a.ll, a.g,
                                         a.demit, a.T, a.B, a.S, a.phases);
  return cudaGetLastError();
}

template <int K, bool PHASES>
cudaError_t launch_d(const Args& a, int threads, int d, cudaStream_t s) {
  switch (d) {
    case 2: return launch<K, 2, PHASES>(a, threads, s);
    case 4: return launch<K, 4, PHASES>(a, threads, s);
    case 8: return launch<K, 8, PHASES>(a, threads, s);
    default: return launch<K, 16, PHASES>(a, threads, s);
  }
}

template <bool PHASES>
cudaError_t run(const Args& a, int depth, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (a.T < 1 || a.B < 1) return cudaErrorInvalidValue;
  int k, threads, d;
  e = plan(a.S, depth, device, &k, &threads, &d);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_d<1, PHASES>(a, threads, d, s);
    case 2: return launch_d<2, PHASES>(a, threads, d, s);
    case 4: return launch_d<4, PHASES>(a, threads, d, s);
    default: return launch_d<8, PHASES>(a, threads, d, s);
  }
}

}  // namespace

// emit, alpha_traj, demit [T, B, S]; act [T, B]; skip_neg, finals_neg
// [B, S]; ll, g [B]; all f32 and contiguous. S <= 8192; depth 0 (the
// default, 16), 2, 4, 8 or 16 steps of rows in the ring.
UASR_EXPORT int uasr_ctc_beta(const float* emit, const float* act, const float* skip,
                              const float* finals, const float* traj, const float* ll,
                              const float* g, float* demit, int T, int B, int S, int depth,
                              void* stream, int device) {
  return run<false>(Args{emit, act, skip, finals, traj, ll, g, demit, T, B, S, nullptr}, depth,
                    stream, device);
}

// The same with the phase stamps: phases [B, NPHASES] int64, thread 0's
// clock64() cycles per phase summed over the steps (waiting for the step's
// rows, the math, the barrier, the stores).
UASR_EXPORT int uasr_ctc_beta_phases(const float* emit, const float* act, const float* skip,
                                     const float* finals, const float* traj, const float* ll,
                                     const float* g, float* demit, int T, int B, int S,
                                     int depth, long long* phases, void* stream, int device) {
  return run<true>(Args{emit, act, skip, finals, traj, ll, g, demit, T, B, S, phases}, depth,
                   stream, device);
}

// The launch plan for S states: threads per CTA and the ring's depth.
UASR_EXPORT int uasr_ctc_beta_plan(int S, int depth, int device, int* threads, int* d) {
  int k;
  return plan(S, depth, device, &k, threads, d);
}
