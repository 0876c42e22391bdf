// K5-bwd: grouped GRU backward (fused: gates recomputed) for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_bwd_kernel (reached
// through pallas_gru_scan's backward rule _bwd_rule -> _bwd_fused, the
// default UASR_GRU_BWD_IMPL=fused).
//
// Inputs, time-major, all of dtype T except the f32 mask: xp [T, G, B, 3H]
// (K5's input), wh [G, H, 3H], bh [G, 3H], tmask [T, G, B], ys
// [T, G, B, H] (K5's output) and its cotangent dy [T, G, B, H]. Outputs:
// dxp [T, G, B, 3H] (d of the input projections, gate order r, z, n) and
// dhn [T, G, B, H] (d of the n block of h_prev @ wh). h_prev at step t is
// ys[t-1] (zero at t = 0), read in the stored dtype.
//
// Two launches: the coefficient kernel of gru_bwd_coeffs.cuh
// (uasr_gru_bwd_coeffs) writes the per-step coefficients c4 and ch for
// every step at once, then the cooperative reverse chain of
// gru_bwd_chain.cuh (uasr_gru_bwd) runs from them. Both address the [T, G,
// B, .] rows through grouped_rows, no group reversed.
//
// Bound: the coefficient kernel's 2 T B H 3H FLOP (all row-steps: the
// masks do not skip its product) and the chain's 2 * steps * H * 3H over
// the live row-steps, against ~0.5 GB moved in f32 at T = 300, B = 64,
// H = 384 (xp, ys, dy, dxp, dhn, and the f32 c4 and ch written once and
// read once): operations in f32, where 3xTF32 takes three tensor-core
// passes and the operand splits per product. At the lc_bigru windows
// (T = 24, B = 1216) the chain's products and its restaging of dhproj
// from L2 set the time; at T = 300, B = 64 its dependent steps do, each a
// barrier and an epilogue.

#include "gru_bwd_coeffs.cuh"

namespace {

using namespace gru_bwd;

// The [T, G, B, .] rows of xp, ys, dy, dxp and dhn
template <typename T>
Layout<T> grouped_layout(const void* xp, const void* ys, const void* dy, void* dxp, void* dhn,
                         int G, int B, int H) {
  return Layout<T>{grouped_rows(static_cast<const T*>(xp), G, B, 3 * H),
                   grouped_rows(static_cast<const T*>(ys), G, B, H),
                   grouped_rows(static_cast<const T*>(dy), G, B, H),
                   grouped_rows(static_cast<T*>(dxp), G, B, 3 * H),
                   grouped_rows(static_cast<T*>(dhn), G, B, H), G};
}

template <typename T>
cudaError_t coeffs(const void* xp, const void* wh, const void* bh, const float* tmask,
                   const void* ys, float* c4, float* ch, int Tn, int G, int B, int H,
                   cudaStream_t stream) {
  return launch_coeffs<T>(grouped_layout<T>(xp, ys, nullptr, nullptr, nullptr, G, B, H),
                          static_cast<const T*>(wh), static_cast<const T*>(bh), tmask, c4, ch,
                          Tn, G, B, H, stream);
}

template <typename T>
cudaError_t chain(const float* c4, const float* ch, const void* dy, const void* wh, void* dxp,
                  void* dhn, float* chd, void* xch, unsigned* bar, int max_groups, int Tn, int G,
                  int B, int H, cudaStream_t stream, int* units, int* splits, int* streamed) {
  const Layout<T> L = grouped_layout<T>(nullptr, nullptr, dy, dxp, dhn, G, B, H);
  return launch_chain<T, float>(c4, ch, L, static_cast<const T*>(wh), chd, static_cast<T*>(xch),
                                bar, max_groups, Tn, G, B, H, stream, units, splits, streamed);
}

}  // namespace

// The coefficient kernel. xp [T, G, B, 3H]; wh [G, H, 3H]; bh [G, 3H]; ys
// [T, G, B, H]: all of `dtype` (UASR_F32 or UASR_BF16). tmask [T, G, B]
// f32. Writes c4 [T, G, B, 4H] and ch [T, G, B, H], f32. H must be a
// multiple of 8.
UASR_EXPORT int uasr_gru_bwd_coeffs(const void* xp, const void* wh, const void* bh,
                                    const float* tmask, const void* ys, float* c4, float* ch,
                                    int T, int G, int B, int H, int dtype, void* stream,
                                    int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || G < 1 || G > 65535 || B < 1 || H < 8 || H % 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return coeffs<float>(xp, wh, bh, tmask, ys, c4, ch, T, G, B, H, st);
  if (dtype == UASR_BF16)
    return coeffs<__nv_bfloat16>(xp, wh, bh, tmask, ys, c4, ch, T, G, B, H, st);
  return cudaErrorInvalidValue;
}

// The reverse chain from the coefficient kernel's c4 [T, G, B, 4H] and ch
// [T, G, B, H] (f32). dy, dhn [T, G, B, H]; dxp [T, G, B, 3H]; wh [G, H, 3H]:
// all of `dtype`. Scratch: chd [G, B, H] f32, xch [2, G, B, 3H] of
// `dtype`; bar 2 * 32 * max_groups zeroed uint32. *units and *splits
// receive the hidden units per CTA and the batch splits per group,
// *streamed 1 where wh streams through the ring (0: resident). H must be a
// multiple of 8.
UASR_EXPORT int uasr_gru_bwd(const float* c4, const float* ch, const void* dy, const void* wh,
                             void* dxp, void* dhn, float* chd, void* xch, unsigned* bar,
                             int max_groups, int T, int G, int B, int H, int dtype, void* stream,
                             int device, int* units, int* splits, int* streamed) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || G < 1 || B < 1 || H < 8 || H % 8 || max_groups < G) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return chain<float>(c4, ch, dy, wh, dxp, dhn, chd, xch, bar, max_groups, T, G, B, H, st,
                        units, splits, streamed);
  if (dtype == UASR_BF16)
    return chain<__nv_bfloat16>(c4, ch, dy, wh, dxp, dhn, chd, xch, bar, max_groups, T, G, B,
                                H, st, units, splits, streamed);
  return cudaErrorInvalidValue;
}
