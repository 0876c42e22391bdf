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

template <typename T, int MT, int NT, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_lin_kernel(const T* __restrict__ c4, const float* __restrict__ ch,
                   const T* __restrict__ dy, const T* __restrict__ wh, T* __restrict__ out,
                   float* chd, T* xch, unsigned* bar, int Tn, int G, int B, int H, int U,
                   int nblk, int S, int Bs, int WM, int BK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  reverse_chain<T, T, true, MT, NT, STREAM>(c4, ch, dy, wh, out, nullptr, nullptr, chd, xch, bar,
                                            Tn, G, B, H, U, nblk, S, Bs, WM, BK,
                                            reinterpret_cast<T*>(smem_raw));
}

template <typename T>
cudaError_t launch(const void* c4, const float* ch, const void* dy, const void* wh, void* out,
                   float* chd, void* xch, unsigned* bar, int max_groups, int Tn, int G, int B,
                   int H, cudaStream_t stream, int* units, int* splits, int* streamed) {
  using Kernel = decltype(&gru_bwd_lin_kernel<T, 1, 2, false>);
  const Kernel kernels[2][TILES] = {
      {gru_bwd_lin_kernel<T, TILE_MT[0], TILE_NT[0], false>,
       gru_bwd_lin_kernel<T, TILE_MT[1], TILE_NT[1], false>},
      {gru_bwd_lin_kernel<T, TILE_MT[0], TILE_NT[0], true>,
       gru_bwd_lin_kernel<T, TILE_MT[1], TILE_NT[1], true>}};
  Plan best;
  cudaError_t e = plan_grid<T>(kernels, TILE_MT, TILE_NT, Operands{3 * H, 1, false},
                                max_groups, G, B, H, &best);
  if (e != cudaSuccess) return e;
  *units = best.U;
  *splits = best.S;
  *streamed = best.stream;
  const T *c = static_cast<const T*>(c4), *dyp = static_cast<const T*>(dy);
  const T* w = static_cast<const T*>(wh);
  T *o = static_cast<T*>(out), *xc = static_cast<T*>(xch);
  int U = best.U, nblk = best.nblk, S = best.S, Bs = best.Bs, WM = best.WM, BK = best.BK;
  void* args[] = {&c,  &ch, &dyp, &w, &o,    &chd, &xc, &bar, &Tn, &G,
                  &B,  &H,  &U,   &nblk, &S, &Bs,  &WM, &BK};
  e = cudaLaunchCooperativeKernel((const void*)kernels[best.stream][best.tile],
                                  dim3(G * S * nblk), dim3(THREADS), args, best.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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
