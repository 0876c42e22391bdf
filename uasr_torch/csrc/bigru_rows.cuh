// K2's tensors as the rows of two groups, shared by K2 (bigru_fwd.cu) and
// K2-bwd (bigru_bwd.cu), so both address them through one definition: a
// pair of frame-ordered [T, B, W] tensors, one per direction (p0 / p1 and
// their gradients), is one family whose group stride is the distance
// between the two; out [T, B, 2H] and its cotangent hold the directions side
// by side (group stride H, row stride 2H). Group 1's kernel step t is frame
// T-1-t (rev_from = 1). Rows of out start at g H + b 2H elements: with
// H % 8 == 0 every row is 16-byte aligned in both dtypes, as cp.async wants.
#pragma once

#include "gru_bwd_chain.cuh"

namespace gru_bwd {

// two [T, B, W] tensors, group 0's and group 1's (both aligned to P)
template <typename P>
Rows<P> bigru_pair_rows(P* a0, P* a1, int B, int W) {
  const long long gs = ((intptr_t)a1 - (intptr_t)a0) / (intptr_t)sizeof(P);
  return Rows<P>{a0, gs, (long long)B * W, W};
}

// [T, B, 2H], the directions side by side
template <typename P>
Rows<P> bigru_out_rows(P* out, int B, int H) {
  return Rows<P>{out, H, 2LL * B * H, 2 * H};
}

// K2's rows: p0 / p1 read, out written
template <typename T>
FwdLayout<T> bigru_fwd_layout(const void* p0, const void* p1, void* out, int B, int H) {
  using C = const T;
  return FwdLayout<T>{
      bigru_pair_rows(static_cast<C*>(p0), static_cast<C*>(p1), B, 3 * H),
      bigru_out_rows(static_cast<T*>(out), B, H), 1};
}

// K2-bwd's rows: p0 / p1 and out (the coefficient kernel) and dout read,
// dxp0 / dxp1 and dhn0 / dhn1 written (the chain)
template <typename T>
Layout<T> bigru_layout(const void* p0, const void* p1, const void* out, const void* dout,
                       void* dxp0, void* dxp1, void* dhn0, void* dhn1, int B, int H) {
  using C = const T;
  return Layout<T>{
      bigru_pair_rows(static_cast<C*>(p0), static_cast<C*>(p1), B, 3 * H),
      bigru_out_rows(static_cast<C*>(out), B, H),
      bigru_out_rows(static_cast<C*>(dout), B, H),
      bigru_pair_rows(static_cast<T*>(dxp0), static_cast<T*>(dxp1), B, 3 * H),
      bigru_pair_rows(static_cast<T*>(dhn0), static_cast<T*>(dhn1), B, H), 1};
}

}  // namespace gru_bwd
