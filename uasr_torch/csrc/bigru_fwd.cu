// K2: two-stream BiGRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_fwd2_kernel
// (reached through pallas_bigru_scan -> _fwd2), forward only.
//
// Inputs, time-major: p0, p1 [T, B, 3H] input projections (bias added)
// of the forward and the reversed stream, both in frame order;
// wh [2, H, 3H], bh [2, 3H]; tmask [T, 2, B] f32 in kernel time (stream
// 1's first T - len steps are its padding prefix). Output [T, B, 2H] =
// (forward states, reversed states in frame order), unmasked. At kernel
// step u stream 0 reads frame u and stream 1 frame T-1-u. Per stream:
//   hproj = h.to(wh dtype) @ wh[g] + bh[g]          (f32 accumulation)
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h_cand = (1 - z) * n + z * h,  h = mf * h_cand + (1 - mf) * h
// and the carry is rounded to the output dtype every step and reread from
// that rounded value, as the TPU kernel does.
//
// Design: K2 is K5 with two groups, group 1's frames reversed, so it
// launches K5's kernel (gru_fwd_kernel.cuh) on K5's persistent grid and
// plan: CTA (g, s, c) owns U hidden units of direction g and a split of
// the batch rows, and each step's product [Bs, H] x [H, 3U] runs on the
// tensor cores (bf16 as stored, f32 as 3xTF32), wh resident in shared
// memory or, where it does not fit, streamed through the ring. Nothing is
// copied, stacked or flipped: the kernel reads p0 / p1 and writes out in
// place through K2's rows (bigru_rows.cuh, shared with K2-bwd), group 1's
// frames reversed by addressing. The plan takes every B (batch splits of
// at least one row) and every H with 2 ceil(H / 64) CTAs within the SMs
// (H <= 4224 on the H100's 132).
//
// Bound: the recurrence is a chain of T dependent steps, each a
// [B, H] x [H, 3H] product per direction (~40 GFLOP over the layer at
// T = 400, B = 32, H = 512: ~0.04 ms at the bf16 tensor-core peak):
// latency, not bytes or FLOPs, sets the time. Per step: a barrier, one
// pass of the split's rows through the ring, the epilogue.

#include "bigru_rows.cuh"
#include "gru_fwd_kernel.cuh"

namespace {

using namespace gru_bwd;

template <typename T>
cudaError_t launch(const void* p0, const void* p1, const void* wh, const void* bh,
                   const float* tmask, void* out, unsigned* bar, int max_groups, int Tn, int B,
                   int H, cudaStream_t stream, int* units, int* splits, int* streamed) {
  return launch_fwd<T>(bigru_fwd_layout<T>(p0, p1, out, B, H), static_cast<const T*>(wh),
                       static_cast<const T*>(bh), tmask, nullptr, nullptr, bar, max_groups, Tn,
                       2, B, H, stream, units, splits, streamed);
}

}  // namespace

// p0, p1 [T, B, 3H], wh [2, H, 3H], bh [2, 3H], out [T, B, 2H] all of
// `dtype` (UASR_F32 or UASR_BF16), 16-byte aligned; tmask [T, 2, B] f32;
// bar 2 * 32 * max_groups zeroed uint32 (one barrier per direction and
// batch split). *units and *splits receive the hidden units per CTA and
// the batch splits per direction, *streamed 1 where wh streams through
// the ring (0: resident). H must be a multiple of 8; 2 ceil(H / 64) CTAs
// must fit the SMs.
UASR_EXPORT int uasr_bigru_fwd(const void* p0, const void* p1, const void* wh, const void* bh,
                               const float* tmask, void* out, unsigned* bar, int max_groups,
                               int T, int B, int H, int dtype, void* stream, int device,
                               int* units, int* splits, int* streamed) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || H < 8 || H % 8 || max_groups < 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(p0, p1, wh, bh, tmask, out, bar, max_groups, T, B, H, st, units, splits,
                         streamed);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(p0, p1, wh, bh, tmask, out, bar, max_groups, T, B, H, st, units,
                                 splits, streamed);
  return cudaErrorInvalidValue;
}
