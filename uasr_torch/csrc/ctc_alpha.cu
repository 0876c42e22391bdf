// K3: CTC alpha recursion for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/ops/pallas_ctc.py::_fwd_kernel (reached
// through ctc_loss_pallas -> _ctc_ll -> _ctc_fwd).
//
// Inputs: emit [T, B, S] f32 (log p of the extended label z_s at frame
// t), act [T, B] f32 (1 = frame active; any {0, 1} mask), skip_neg and
// svalid_neg [B, S] f32 additive masks (0 or -1e5). Output alpha_traj
// [T, B, S] f32, the alpha of every step. Starting from the virtual seed
// alpha_{-1} = [0, NEG, ...], each step is
//   new   = lse3(alpha[s], alpha[s-1], alpha[s-2] + skip[s]) + emit[t, s]
//   new   = max(new + svalid[s], NEG)
//   alpha = act[t] * new + (1 - act[t]) * alpha
// with shifted-in values NEG and lse3's max floored at NEG, as the TPU
// kernel does, with expf and logf (no fast-math). Log-zero is the finite
// -1e5; nothing is ever -inf. An inactive step carries alpha over.
//
// Bound: the bytes are emit in and alpha_traj out (26 MB each at T = 400,
// B = 32, S = 513, ~0.016 ms at 3.35 TB/s), but the T steps form a chain
// and one utterance's states live in one CTA, so the time is T times the
// time of one step on one SM.
//
// Design: one CTA per utterance, its S states spread over the threads, K
// states per thread (thread i owns i, i + n, ...; K a template parameter,
// the least power of two that fits 1024 threads: 1 up to S = 1024, then
// 2, 4, 8), each thread's alpha in registers. The s-1 and s-2 neighbours
// come through a double-buffered row in shared memory, so a step costs
// one __syncthreads. The split of the kernel this replaced
// (uasr_torch/tools/time_ctc.py) showed its math phase, not the wait for
// its row, taking three quarters of a step, and its SASS showed why: with
// K a runtime count up to 8, every step issued the addresses and guarded
// loads of eight state slots (some 70 instructions ahead of one state's
// math) and spilled under the 64-register cap. With K fixed no thread
// issues work for states it does not own; at S = 513 the step is then the
// issue of 17 warps' instructions on one SM (two states per thread were
// slower). Each step's emit row and act value come into
// a ring of D slots in shared memory, D - 1 steps ahead of the chain, by
// 4-byte cp.async (a row starts at ((t B + b) S) 4 bytes, not 16-byte
// aligned at odd S), the ring's addresses carried from copy to copy:
// each thread copies and later reads only its own states' elements, so
// its own cp.async.wait_group orders them; thread 0 copies act, and its
// wait comes before the barrier after which every thread reads it. D is
// 16 unless the caller asks for 2, 4 or 8, and halves while the ring does
// not fit shared memory (D = 4 at S = 8192). alpha rows are written
// coalesced over s.

#include "common.cuh"

namespace {

constexpr float NEG = -1e5f;
constexpr int THREADS_MAX = 1024;
constexpr int MAXK = 8;  // states per thread (S <= 8 * 1024)
constexpr int DEFAULT_DEPTH = 16;
// phase stamps (uasr_ctc_alpha_phases): thread 0's clock64() deltas per
// phase, summed over the steps
enum { PH_ROWS, PH_MATH, PH_BARRIER, PH_STORES, NPHASES };

size_t smem_bytes(int S, int D) { return ((size_t)(2 + D) * S + D) * sizeof(float); }

template <int K, int D, bool PHASES>
__global__ void __launch_bounds__(THREADS_MAX)
ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ act,
                 const float* __restrict__ skip, const float* __restrict__ svalid,
                 float* __restrict__ traj, int Tn, int B, int S,
                 long long* __restrict__ phases) {
  extern __shared__ float smem[];
  // [2][S] alpha rows, then the ring: [D][S] emit rows, [D] act values
  float* cur = smem;
  float* nxt = smem + S;
  const float* ring = smem + 2 * S;
  const float* ring_act = ring + D * S;
  const int b = blockIdx.x, nt = blockDim.x, tid = threadIdx.x;
  const size_t step = (size_t)B * S;  // one frame of emit and alpha_traj
  bool own[K];                        // state tid + k nt exists
#pragma unroll
  for (int k = 0; k < K; ++k) own[k] = tid + k * nt < S;
  // the ring's next copy: step u, this thread's emit elements from src
  // (act from actsrc, thread 0) into slot u % D at shared-space address w
  // (wa for act), both carried from copy to copy so no step recomputes
  // them; past the last step an empty group, so the waits count alike
  int u = 0;
  const float* src = emit + (size_t)b * S + tid;
  const float* actsrc = act + b;
  uint32_t w = smem_u32(ring + tid), wa = smem_u32(ring_act);
  const uint32_t slot_bytes = 4 * S, wrap_bytes = 4 * (D - 1) * S;
  auto issue = [&]() {
    if (u < Tn) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (own[k]) cp_async4(w + 4 * k * nt, src + k * nt);
      if (tid == 0) cp_async4(wa, actsrc);
      const bool wrap = (u & (D - 1)) == D - 1;
      w = wrap ? w - wrap_bytes : w + slot_bytes;
      wa = wrap ? wa - 4 * (D - 1) : wa + 4;
      src += step;
      actsrc += B;
    }
    ++u;
    cp_commit();
  };
  float a[K], sk[K], sv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    a[k] = sk[k] = sv[k] = 0.f;
    if (own[k]) {
      a[k] = s == 0 ? 0.f : NEG;  // virtual seed alpha_{-1}
      sk[k] = skip[(size_t)b * S + s];
      sv[k] = svalid[(size_t)b * S + s];
      cur[s] = a[k];
    }
  }
  for (int i = 0; i < D - 1; ++i) issue();
  cp_wait<D - 2>();  // step 0's group
  __syncthreads();
  long long ph[NPHASES] = {}, t_prev = PHASES ? clock64() : 0;
  auto stamp = [&](int p) {
    if constexpr (PHASES) {
      const long long now = clock64();
      ph[p] += now - t_prev;
      t_prev = now;
    }
  };
  float* row = traj + (size_t)b * S + tid;
  for (int t = 0; t < Tn; ++t) {
    // into slot (t - 1) % D: every thread read it before the last barrier
    issue();
    stamp(PH_ROWS);
    const float* e = ring + (t & (D - 1)) * S;
    const float mf = ring_act[t & (D - 1)];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (own[k]) {
        const float a0 = a[k];
        const float a1 = s >= 1 ? cur[s - 1] : NEG;
        const float a2 = (s >= 2 ? cur[s - 2] : NEG) + sk[k];
        float m = fmaxf(fmaxf(a0, a1), a2);
        m = fmaxf(m, NEG);
        float nw = m + logf(expf(a0 - m) + expf(a1 - m) + expf(a2 - m));
        nw = nw + e[s];
        nw = fmaxf(nw + sv[k], NEG);
        a[k] = mf * nw + (1.f - mf) * a0;
      }
    }
    stamp(PH_MATH);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (own[k]) {
        nxt[tid + k * nt] = a[k];
        row[k * nt] = a[k];
      }
    }
    row += step;
    stamp(PH_STORES);
    cp_wait<D - 2>();  // step t + 1's group (thread 0: its act too)
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
  const float *emit, *act, *skip, *svalid;
  float* traj;
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
  auto kernel = ctc_alpha_kernel<K, D, PHASES>;
  const size_t smem = smem_bytes(a.S, D);
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.B, threads, smem, stream>>>(a.emit, a.act, a.skip, a.svalid, a.traj, a.T, a.B,
                                         a.S, a.phases);
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

// emit [T, B, S], act [T, B], skip_neg / svalid_neg [B, S], alpha_traj
// [T, B, S], all f32 and contiguous. S <= 8192; depth 0 (the default, 16),
// 2, 4, 8 or 16 steps of rows in the ring.
UASR_EXPORT int uasr_ctc_alpha(const float* emit, const float* act, const float* skip,
                               const float* svalid, float* traj, int T, int B, int S, int depth,
                               void* stream, int device) {
  return run<false>(Args{emit, act, skip, svalid, traj, T, B, S, nullptr}, depth, stream,
                    device);
}

// The same with the phase stamps: phases [B, NPHASES] int64, thread 0's
// clock64() cycles per phase summed over the steps (waiting for the step's
// rows, the math, the barrier, the stores).
UASR_EXPORT int uasr_ctc_alpha_phases(const float* emit, const float* act, const float* skip,
                                      const float* svalid, float* traj, int T, int B, int S,
                                      int depth, long long* phases, void* stream, int device) {
  return run<true>(Args{emit, act, skip, svalid, traj, T, B, S, phases}, depth, stream, device);
}

// The launch plan for S states: threads per CTA and the ring's depth.
UASR_EXPORT int uasr_ctc_alpha_plan(int S, int depth, int device, int* threads, int* d) {
  int k;
  return plan(S, depth, device, &k, threads, d);
}
