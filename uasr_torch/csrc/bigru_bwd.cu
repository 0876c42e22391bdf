// K2-bwd: two-stream BiGRU backward for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/models/pallas_gru.py::_bwd2_kernel
// (reached through pallas_bigru_scan's backward rule _bwd2_rule).
//
// Inputs, time-major, all of dtype T except the f32 mask: p0, p1
// [T, B, 3H] (K2's inputs, frame order), wh [2, H, 3H], bh [2, 3H],
// tmask [T, 2, B] in kernel time, out [T, B, 2H] (K2's output) and its
// cotangent dout [T, B, 2H]. Outputs in frame order: dxp0, dxp1
// [T, B, 3H] (d of the input projections, gate order r, z, n) and dhn0,
// dhn1 [T, B, H] (d of the n block of h_prev @ wh). Stream g's kernel
// step u reads frame u (g = 0) or T-1-u (g = 1); h_prev at step u is
// the output row of step u-1 (zero at u = 0): frame u-1 of stream 0, frame
// T-u of stream 1 (_bwd2_rule's shift), read in the stored dtype.
//
// It is K5-bwd's backward with G = 2 (the same coefficient expressions,
// chain and rounding points as pallas_gru.py:198-231 against :591-636), so
// it is K5-bwd's two launches: the coefficient kernel of
// gru_bwd_coeffs.cuh (uasr_bigru_bwd_coeffs) writes c4 [T, 2, B, 4H] and
// ch [T, 2, B, H] in f32 and kernel time, then the cooperative reverse
// chain of gru_bwd_chain.cuh (uasr_bigru_bwd) runs from them, both products
// on the tensor cores (bf16 as stored, f32 as 3xTF32). Neither copies,
// stacks or flips anything: their Layout (K2's rows, bigru_rows.cuh, shared
// with K2) reads and writes K2's tensors in place, p0 / p1 and dxp0 / dxp1
// and dhn0 / dhn1 as the two groups' bases, out and dout with the
// directions side by side (sb = 2H), and group 1's frames reversed by
// addressing.
//
// Bound: the coefficient product and the chain's per-step products are
// 2 * T * 2 * B * H * 3H FLOP each (~80 GFLOP in all at T = 400, B = 32,
// H = 512; ~0.08 ms at bf16 tensor-core peak) against ~0.2 GB moved in
// bf16 (and the f32 c4 and ch, written once and read once). At B = 32 the
// chain's 400 dependent steps, each a barrier and an epilogue, set the
// time.

#include "bigru_rows.cuh"
#include "gru_bwd_coeffs.cuh"

namespace {

using namespace gru_bwd;

template <typename T>
cudaError_t coeffs(const void* p0, const void* p1, const void* wh, const void* bh,
                   const float* tmask, const void* out, float* c4, float* ch, int Tn, int B,
                   int H, cudaStream_t stream) {
  const Layout<T> L =
      bigru_layout<T>(p0, p1, out, nullptr, nullptr, nullptr, nullptr, nullptr, B, H);
  return launch_coeffs<T>(L, static_cast<const T*>(wh), static_cast<const T*>(bh), tmask, c4,
                          ch, Tn, 2, B, H, stream);
}

template <typename T>
cudaError_t chain(const float* c4, const float* ch, const void* dout, const void* wh, void* dxp0,
                  void* dxp1, void* dhn0, void* dhn1, float* chd, void* xch, unsigned* bar,
                  int max_groups, int Tn, int B, int H, cudaStream_t stream, int* units,
                  int* splits, int* streamed) {
  const Layout<T> L =
      bigru_layout<T>(nullptr, nullptr, nullptr, dout, dxp0, dxp1, dhn0, dhn1, B, H);
  return launch_chain<T, float>(c4, ch, L, static_cast<const T*>(wh), chd, static_cast<T*>(xch),
                                bar, max_groups, Tn, 2, B, H, stream, units, splits, streamed);
}

}  // namespace

// The coefficient kernel. p0, p1 [T, B, 3H]; wh [2, H, 3H]; bh [2, 3H];
// out [T, B, 2H]: all of `dtype` (UASR_F32 or UASR_BF16), 16-byte
// aligned. tmask [T, 2, B] f32 in kernel time. Writes c4 [T, 2, B, 4H] and
// ch [T, 2, B, H], f32, in kernel time. H must be a multiple of 8.
UASR_EXPORT int uasr_bigru_bwd_coeffs(const void* p0, const void* p1, const void* wh,
                                      const void* bh, const float* tmask, const void* out,
                                      float* c4, float* ch, int T, int B, int H, int dtype,
                                      void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || H < 8 || H % 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32) return coeffs<float>(p0, p1, wh, bh, tmask, out, c4, ch, T, B, H, st);
  if (dtype == UASR_BF16)
    return coeffs<__nv_bfloat16>(p0, p1, wh, bh, tmask, out, c4, ch, T, B, H, st);
  return cudaErrorInvalidValue;
}

// The reverse chain from the coefficient kernel's c4 and ch. dout [T, B,
// 2H]; wh [2, H, 3H]; outputs dxp0, dxp1 [T, B, 3H] and dhn0, dhn1 [T, B,
// H] in frame order: all of `dtype`, 16-byte aligned. Scratch: chd
// [2, B, H] f32, xch [2, 2, B, 3H] of `dtype`; bar 2 * 32 * max_groups
// zeroed uint32. *units and *splits receive the hidden units per CTA and
// the batch splits per direction, *streamed 1 where wh streams through the
// ring (0: resident). H must be a multiple of 8.
UASR_EXPORT int uasr_bigru_bwd(const float* c4, const float* ch, const void* dout,
                               const void* wh, void* dxp0, void* dxp1, void* dhn0, void* dhn1,
                               float* chd, void* xch, unsigned* bar, int max_groups, int T,
                               int B, int H, int dtype, void* stream, int device, int* units,
                               int* splits, int* streamed) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (T < 1 || B < 1 || H < 8 || H % 8 || max_groups < 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return chain<float>(c4, ch, dout, wh, dxp0, dxp1, dhn0, dhn1, chd, xch, bar, max_groups, T,
                        B, H, st, units, splits, streamed);
  if (dtype == UASR_BF16)
    return chain<__nv_bfloat16>(c4, ch, dout, wh, dxp0, dxp1, dhn0, dhn1, chd, xch, bar,
                                max_groups, T, B, H, st, units, splits, streamed);
  return cudaErrorInvalidValue;
}
