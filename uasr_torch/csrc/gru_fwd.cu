// K5: grouped GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_fwd_kernel (reached
// through pallas_gru_scan -> _fwd), with its save_coeffs outputs.
//
// Inputs, time-major: xp [T, G, B, 3H] input projections (bias added);
// wh [G, H, 3H], bh [G, 3H]; tmask [T, G, B] f32. Output ys [T, G, B, H],
// unmasked. Every group scans forward in frame order (GRULayer reverses
// its own input). The step, its rounding points and the save_coeffs
// outputs (c4 [T, G, B, 4H] in T, ch [T, G, B, H] f32) are those of
// gru_fwd_kernel.cuh.
//
// Design: the kernel of gru_fwd_kernel.cuh (shared with K2) over [T, G, B,
// .] rows (grouped_rows, no group reversed): the chain's persistent grid
// and plan, each step's product [Bs, H] x [H, 3U] on the tensor cores, wh
// resident in shared memory or streamed through the ring.
//
// Bound: a chain of T dependent steps, each 2 B H 3H FLOP per group (three
// tensor-core passes in f32). At the lc_bigru backward windows (T = 24,
// B = 1216, H = 384) the products and the restaging of h rows from L2 set
// the time; offline (T = 300, B = 64) each step's latency does: a barrier,
// one pass of 16 rows, the epilogue.

#include "gru_fwd_kernel.cuh"

namespace {

using namespace gru_bwd;

template <typename T>
cudaError_t launch(const void* xp, const void* wh, const void* bh, const float* tmask, void* ys,
                   void* c4, float* ch, unsigned* bar, int max_groups, int Tn, int G, int B,
                   int H, cudaStream_t stream, int* units, int* splits, int* streamed) {
  const FwdLayout<T> L{grouped_rows(static_cast<const T*>(xp), G, B, 3 * H),
                       grouped_rows(static_cast<T*>(ys), G, B, H), G};
  return launch_fwd<T>(L, static_cast<const T*>(wh), static_cast<const T*>(bh), tmask,
                       static_cast<T*>(c4), ch, bar, max_groups, Tn, G, B, H, stream, units,
                       splits, streamed);
}

}  // namespace

// xp [T, G, B, 3H], wh [G, H, 3H], bh [G, 3H], ys [T, G, B, H] all of
// `dtype` (UASR_F32 or UASR_BF16); tmask [T, G, B] f32; c4 [T, G, B, 4H]
// of `dtype` and ch [T, G, B, H] f32, both null or both given (save_coeffs);
// bar 2 * 32 * max_groups zeroed uint32 (one barrier per group and split).
// *units and *splits receive the hidden units per CTA and the batch splits
// per group, *streamed 1 where wh streams through the ring (0: resident).
// H must be a multiple of 8; G ceil(H / 64) CTAs must fit the SMs.
UASR_EXPORT int uasr_gru_fwd(const void* xp, const void* wh, const void* bh, const float* tmask,
                             void* ys, void* c4, float* ch, unsigned* bar, int max_groups, int T,
                             int G, int B, int H, int dtype, void* stream, int device, int* units,
                             int* splits, int* streamed) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || G < 1 || B < 1 || H < 8 || H % 8 || max_groups < G || (!c4) != (!ch))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(xp, wh, bh, tmask, ys, c4, ch, bar, max_groups, T, G, B, H, st, units,
                         splits, streamed);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(xp, wh, bh, tmask, ys, c4, ch, bar, max_groups, T, G, B, H, st,
                                 units, splits, streamed);
  return cudaErrorInvalidValue;
}
