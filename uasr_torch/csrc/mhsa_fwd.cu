// K6: fused multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/ops/pallas_attention.py::_fwd_kernel
// (reached through fused_dot_product_attention -> _attn_core -> _fwd),
// forward only.
//
// Inputs: q, k, v [B, Tp, H * dh] (heads are column slices of the packed
// projection, no relayout); kmask [B, 1, Tp] int32 key validity; bias
// [H, Tp, Tp] f32 shared by the batch, or none. Outputs: out [B, Tp, H * dh]
// in q's dtype and lse [B, H, Tp] f32. For each (b, head h), as the TPU
// kernel computes it:
//   s = (q_h k_h^T) * (1 / sqrt(dh))   (f32 accumulation, scale after)
//   s += bias[h];  s += 0 or -1e30 by key mask
//   m = rowmax(s);  e = exp(s - m);  l = sum(e)  (f32)
//   o = e.to(q dtype) @ v_h  (f32 accumulation);  out = (o / l).to(q dtype)
//   lse = m + log(l)
//
// Design: one CTA of one warpgroup per (batch row, 64-row query tile,
// head); the batch row is the fastest grid axis, so the CTAs resident
// together read the same bias rows [h, tile, :] and share them in L2. Keys
// come in tiles of 64 through a two-stage cp.async ring
// (mhsa_tiles.cuh), so shared memory does not grow with Tp and any Tp
// that is a multiple of 8 runs. The row max must be exact before any exp
// (an online softmax would round e against a running max and drift from
// the TPU in bf16), so the CTA makes two passes over the keys: pass 1
// forms S = Q K^T (wgmma, f32), scale, bias and mask and keeps the row
// max; pass 2 forms S again and e = exp(s - m), sums l, rounds e to bf16
// in registers and accumulates O += e V on wgmma against that fixed max,
// with no rescaling. Keys past Tp in the last tile are dropped (score
// -inf, e = 0), not masked with -1e30, so a row whose keys are all masked
// still averages over exactly Tp keys. f32 runs the same two passes with
// the products on CUDA cores (mhsa_tiles.cuh's Ops<float>).
//
// Bound: 4 B H Tp^2 dh operations on bf16 inputs (6 with the second QK^T
// pass) against 4 B Tp H dh elements plus the H Tp^2 f32 bias: bytes at
// B = 32, Tp = 400, 8 x 64 (~58 MB against ~10.5 GFLOP on the tensor
// cores). The bias is read twice per CTA from L2; K and V once per query
// tile.

#include "mhsa_tiles.cuh"

namespace {

using namespace mhsa;

template <typename T, int DH>
constexpr size_t fwd_smem() {
  // Q, the stages of K, V and the key mask, P staging (f32)
  using O = Ops<T, DH>;
  return (1 + 2 * STAGES) * O::TILE_BYTES + STAGES * TILE * sizeof(int) + O::SCRATCH_BYTES;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ kmask, const float* __restrict__ bias, T* out,
                float* lse, int Tp, int H, float scale) {
  using O = Ops<T, DH>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + O::TILE_BYTES;           // [STAGES]
  uint8_t* v_s = k_s + STAGES * O::TILE_BYTES;  // [STAGES]
  int* km_s = reinterpret_cast<int*>(v_s + STAGES * O::TILE_BYTES);  // [STAGES][TILE]
  float* scratch = reinterpret_cast<float*>(km_s + STAGES * TILE);

  const int b = blockIdx.x, q0 = blockIdx.y * TILE, h = blockIdx.z;
  const int D = H * DH, nkt = (Tp + TILE - 1) / TILE, steps = 2 * nkt;
  const size_t base = (size_t)b * Tp * D + (size_t)h * DH;
  const int* km_b = kmask + (size_t)b * Tp;
  const float* bias_h = bias ? bias + (size_t)h * Tp * Tp : nullptr;
  const Frag f;
  const int row0 = q0 + f.r0, row1 = row0 + 8;

  // step s < nkt: pass 1, key tile s; s >= nkt: pass 2, key and value tile s - nkt
  auto load_step = [&](int step) {
    if (step < steps) {
      const int st = step % STAGES, k0 = (step % nkt) * TILE;
      O::load(k_s + st * O::TILE_BYTES, k + base + (size_t)k0 * D, D, Tp - k0);
      if (step >= nkt) O::load(v_s + st * O::TILE_BYTES, v + base + (size_t)k0 * D, D, Tp - k0);
      load_row_chunk(km_s + st * TILE, km_b + k0, Tp - k0);
    }
    cp_commit();
  };

  O::load(q_s, q + base + (size_t)q0 * D, D, Tp - q0);  // joins step 0's group
  for (int i = 0; i < STAGES - 1; ++i) load_step(i);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    load_step(step + STAGES - 1);
    cp_wait<STAGES - 1>();
    fence_async_smem();
    __syncthreads();
    const int st = step % STAGES, k0 = (step % nkt) * TILE;
    float s[32];
    O::begin(s);
    O::nt(s, q_s, k_s + st * O::TILE_BYTES);
    O::commit();
    // this thread's bias pairs, loaded while the product runs
    float2 bv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + 8 * j + f.c;
      const bool ok = bias_h && col < Tp;
      bv[2 * j] = ok && row0 < Tp
                      ? *reinterpret_cast<const float2*>(bias_h + (size_t)row0 * Tp + col)
                      : make_float2(0.f, 0.f);
      bv[2 * j + 1] = ok && row1 < Tp
                          ? *reinterpret_cast<const float2*>(bias_h + (size_t)row1 * Tp + col)
                          : make_float2(0.f, 0.f);
    }
    O::wait(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + f.c + e;
        const float madd = k0 + col < Tp ? (km_s[st * TILE + col] > 0 ? 0.f : NEG) : -INFINITY;
        const float b0 = e ? bv[2 * j].y : bv[2 * j].x, b1 = e ? bv[2 * j + 1].y : bv[2 * j + 1].x;
        s[4 * j + e] = __fadd_rn(__fadd_rn(__fmul_rn(s[4 * j + e], scale), b0), madd);
        s[4 * j + 2 + e] = __fadd_rn(__fadd_rn(__fmul_rn(s[4 * j + 2 + e], scale), b1), madd);
      }
    if (step < nkt) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    } else {
      if (step == nkt) {  // the quad's four threads hold one row
        m0 = quad_max(m0);
        m1 = quad_max(m1);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = expf(__fsub_rn(s[4 * j + e], m0));
          s[4 * j + 2 + e] = expf(__fsub_rn(s[4 * j + 2 + e], m1));
          l0 += s[4 * j + e];
          l1 += s[4 * j + 2 + e];
        }
      typename O::PFrag pf;
      O::round_frag(pf, s);
      O::begin(o);
      O::rs(o, pf, v_s + st * O::TILE_BYTES, scratch);
      O::commit();
      O::wait(o);
    }
    __syncthreads();  // stage st is refilled at the next step
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const size_t col = base + 8 * j + f.c;
    if (row0 < Tp)
      store_pair(out + col + (size_t)row0 * D, __fdiv_rn(o[4 * j], l0),
                 __fdiv_rn(o[4 * j + 1], l0));
    if (row1 < Tp)
      store_pair(out + col + (size_t)row1 * D, __fdiv_rn(o[4 * j + 2], l1),
                 __fdiv_rn(o[4 * j + 3], l1));
  }
  if (threadIdx.x % 4 == 0) {
    float* lse_bh = lse + ((size_t)b * H + h) * Tp;
    if (row0 < Tp) lse_bh[row0] = m0 + logf(l0);
    if (row1 < Tp) lse_bh[row1] = m1 + logf(l1);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kmask,
                   const float* bias, void* out, float* lse, int B, int Tp, int H, float scale,
                   cudaStream_t stream) {
  auto kernel = mhsa_fwd_kernel<T, DH>;
  constexpr size_t smem = fwd_smem<T, DH>();
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, (Tp + TILE - 1) / TILE, H);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), kmask, bias,
                                          static_cast<T*>(out), lse, Tp, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, const int* kmask,
                     const float* bias, void* out, float* lse, int B, int Tp, int H,
                     float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
    case 32: return launch<T, 32>(q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
    case 64: return launch<T, 64>(q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
    case 128: return launch<T, 128>(q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out [B, Tp, H * dh] of `dtype` (UASR_F32 or UASR_BF16); kmask
// [B, 1, Tp] int32; bias [H, Tp, Tp] f32 or null; lse [B, H, Tp] f32.
// Tp must be a multiple of 8 and dh one of 16, 32, 64, 128; scale is
// 1 / sqrt(dh) rounded to f32 by the caller.
UASR_EXPORT int uasr_mhsa_fwd(const void* q, const void* k, const void* v, const int* kmask,
                              const float* bias, void* out, float* lse, int B, int Tp, int H,
                              int dh, float scale, int dtype, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || H < 1 || H > 65535 || Tp < 8 || Tp % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return dispatch<float>(dh, q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
  if (dtype == UASR_BF16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
  return cudaErrorInvalidValue;
}
