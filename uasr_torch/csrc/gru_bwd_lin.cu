// K8: grouped GRU backward (linear: coefficients from the forward) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_bwd_lin_kernel
// (reached through pallas_gru_scan's backward rule _bwd_rule ->
// _bwd_linear when UASR_GRU_BWD_IMPL=linear).
//
// Inputs: c4 [T, G, B, 4H] of dtype T and ch [T, G, B, H] f32, the
// linearisation coefficients K5 wrote with save_coeffs (gru_fwd.cu); dy
// [T, G, B, H] and wh [G, H, 3H] of dtype T. Output out [T, G, B, 4H] of
// dtype T: (dr_pre, dz_pre, dn_pre, dhn), the reverse chain of
// gru_bwd_chain.cuh with the coefficients read from c4 (in bf16 they were
// rounded by the forward, so in bf16 this and K5-bwd differ, as the two
// TPU variants do). dxp = out[..., :3H]; dwh and dbh come from columns
// 0:2H and 3H:4H outside the kernel.
//
// Design: K5-bwd's reverse chain alone (gru_bwd_chain.cuh), on the same
// persistent cooperative grid: no gate recomputation and no
// transcendentals, one tensor-core product [rows, 3H] x [3H, U] per CTA
// and step.
//
// Bound: 2 * steps * H * 3H FLOP over the active row-steps, and the bytes
// of c4, ch, dy, wh and out (~0.3 GB in f32 at T = 300, B = 64, H = 384):
// operations in f32, bytes in bf16; the chain of T dependent steps with a
// barrier each sets the time.

#include "gru_bwd_chain.cuh"

namespace {

using namespace gru_bwd;

// dy in [T, G, B, H] rows; out's [T, G, B, 4H] rows taken as dxp (its
// first 3H) and dhn (its last H)
template <typename T>
cudaError_t launch(const void* c4, const float* ch, const void* dy, const void* wh, void* out,
                   float* chd, void* xch, unsigned* bar, int max_groups, int Tn, int G, int B,
                   int H, cudaStream_t stream, int* units, int* splits, int* streamed) {
  T* o = static_cast<T*>(out);
  const Layout<T> L{{}, {}, grouped_rows(static_cast<const T*>(dy), G, B, H),
                    grouped_rows(o, G, B, 4 * H), grouped_rows(o + 3 * H, G, B, 4 * H), G};
  return launch_chain<T, T>(static_cast<const T*>(c4), ch, L, static_cast<const T*>(wh), chd,
                            static_cast<T*>(xch), bar, max_groups, Tn, G, B, H, stream, units,
                            splits, streamed);
}

}  // namespace

// c4, out [T, G, B, 4H], dy [T, G, B, H], wh [G, H, 3H]: all of `dtype`
// (UASR_F32 or UASR_BF16); ch [T, G, B, H] f32; scratch chd [G, B, H] f32
// and xch [2, G, B, 3H] of `dtype`; bar 2 * 32 * max_groups zeroed uint32.
// *units and *splits receive the hidden units per CTA and the batch splits
// per group, *streamed 1 where wh streams through the ring (0: resident).
// H must be a multiple of 8.
UASR_EXPORT int uasr_gru_bwd_lin(const void* c4, const float* ch, const void* dy, const void* wh,
                                 void* out, float* chd, void* xch, unsigned* bar, int max_groups,
                                 int T, int G, int B, int H, int dtype, void* stream, int device,
                                 int* units, int* splits, int* streamed) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || G < 1 || B < 1 || H < 8 || H % 8 || max_groups < G) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return launch<float>(c4, ch, dy, wh, out, chd, xch, bar, max_groups, T, G, B, H, st, units,
                         splits, streamed);
  if (dtype == UASR_BF16)
    return launch<__nv_bfloat16>(c4, ch, dy, wh, out, chd, xch, bar, max_groups, T, G, B, H, st,
                                 units, splits, streamed);
  return cudaErrorInvalidValue;
}
