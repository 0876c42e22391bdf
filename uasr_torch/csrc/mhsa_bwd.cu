// K6-bwd: fused multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel uasr/ops/pallas_attention.py::_bwd_kernel
// (reached through _attn_core's custom VJP, _attn_bwd_rule).
//
// Inputs: q, k, v, out, dout [B, Tp, H * dh] (K6's inputs and output, the
// cotangent cast to q's dtype; heads are column slices); kmask [B, 1, Tp]
// int32; lse [B, H, Tp] f32 from K6; bias [H, Tp, Tp] f32 or none.
// Outputs: dq, dk, dv [B, Tp, H * dh] in q's dtype and, with a bias,
// d_bias [H, Tp, Tp] f32. For each (b, head h), as the TPU kernel computes
// it (:128-168):
//   s = (q_h k_h^T) * scale + bias[h] + (0 or -1e30 by key mask)   (f32)
//   p = exp(s - lse)                     exact per element: lse is given
//   dv = round(p)^T do_h;  dp = do_h v_h^T;  delta = rowsum(do_h * o_h)
//   t = p (dp - delta);  d_bias[h] += t   (summed over b in ascending order)
//   tb = round(t * scale);  dq = tb k_h;  dk = tb^T q_h
// round() is to q's dtype, products accumulate in f32, and dq, dk, dv are
// rounded to q's dtype once.
//
// Design: three launches, no atomics.
// - delta: one thread per (b, h, row).
// - dq (and d_bias): one CTA per (query tile of QT = 32 rows, head) that
//   walks the batch rows in ascending order (with a bias; without one, a
//   CTA per batch row too). It stages the tile's q, do, lse and delta, then
//   the keys in chunks of KC = 64 (k, v, key mask), forms the tile's t
//   chunk by chunk (a thread per key, QT / 4 rows each), adds it into
//   d_bias in place (the CTA owns those rows of d_bias for every b, so the
//   f32 sum runs b = 0, 1, ... as on the TPU), and accumulates dq = tb k.
// - dk, dv: one CTA per (key tile of KT = 32, head, batch row), walking the
//   queries in chunks of QC = 64 and recomputing p and t for its keys.
// Shared memory does not grow with Tp, so the backward takes any Tp that
// is a multiple of 8 (K6's forward stops at 512 at dh = 64).
//
// Bound: 10 B H Tp^2 dh operations (the TPU cost estimate; the key mask
// leaves fewer live) against ~8 B Tp H dh elements plus 2 H Tp^2 f32 of
// bias and d_bias: bytes in bf16 at B = 32, Tp = 400, 8 x 64 (~0.1 GB
// against ~2.6 GFLOP on tensor cores), operations in f32. This kernel runs
// the products on CUDA cores in f32 and recomputes s and dp in both
// passes; wgmma tiles are later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr int QT = 32;  // dq pass: query rows per CTA
constexpr int KC = 64;  // dq pass: keys per chunk
constexpr int KT = 32;  // dk/dv pass: keys per CTA
constexpr int QC = 64;  // dk/dv pass: query rows per chunk

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int Tp, int H, int DH) {
  const size_t n = (size_t)B * H * Tp;
  for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * THREADS) {
    const int i = idx % Tp;
    const size_t bh = idx / Tp;
    const int h = bh % H, b = bh / H;
    const size_t off = ((size_t)b * Tp + i) * H * DH + (size_t)h * DH;
    float acc = 0.f;
    for (int c = 0; c < DH; ++c) acc = fmaf(to_f32(dout[off + c]), to_f32(out[off + c]), acc);
    delta[idx] = acc;
  }
}

// Stage rows [r0, r0 + n) of head h of a [B, Tp, H * DH] tensor into a
// [rows][DH + 4] f32 tile (zeros past n).
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, size_t base, int D, int r0,
                                           int n, int rows, float* dst) {
  for (int i = threadIdx.x; i < rows * DH; i += THREADS) {
    const int r = i / DH, c = i - r * DH;
    dst[r * (DH + 4) + c] = r < n ? to_f32(x[base + (size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// t = p (dp - delta) and p over ROWS query rows x COLS keys of one (b, h).
// Thread (key c = tid % COLS, row group rg = tid / COLS) owns rows rg,
// rg + NG, ... Writes round(t * scale) to tb_s and, if pb_s, round(p) to
// pb_s ([ROWS][COLS + 4]); with dbias_h, adds t into d_bias in place (sets
// it at the first batch row). Rows past nrows and keys past ncols give 0.
template <typename T, int DH, int ROWS, int COLS>
__device__ __forceinline__ void score_tile(const float* q_s, const float* do_s, const float* k_s,
                                           const float* v_s, const float* lse_s,
                                           const float* delta_s, const float* madd_s,
                                           const float* bias_h, float* dbias_h, bool first,
                                           int i0, int j0, int nrows, int ncols, int Tp,
                                           float scale, float* tb_s, float* pb_s) {
  constexpr int NG = THREADS / COLS, RPT = ROWS / NG, KS = DH + 4, TS = COLS + 4;
  const int c = threadIdx.x % COLS, rg = threadIdx.x / COLS;
  float as[RPT], ap[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) as[r] = ap[r] = 0.f;
  const float* kr = k_s + c * KS;
  const float* vr = v_s + c * KS;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
    const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = rg + r * NG;
      const float4 q4 = *reinterpret_cast<const float4*>(q_s + i * KS + d);
      const float4 o4 = *reinterpret_cast<const float4*>(do_s + i * KS + d);
      as[r] = fmaf(q4.x, k4.x, as[r]);
      as[r] = fmaf(q4.y, k4.y, as[r]);
      as[r] = fmaf(q4.z, k4.z, as[r]);
      as[r] = fmaf(q4.w, k4.w, as[r]);
      ap[r] = fmaf(o4.x, v4.x, ap[r]);
      ap[r] = fmaf(o4.y, v4.y, ap[r]);
      ap[r] = fmaf(o4.z, v4.z, ap[r]);
      ap[r] = fmaf(o4.w, v4.w, ap[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg + r * NG;
    float t = 0.f, p = 0.f;
    if (i < nrows && c < ncols) {
      const size_t off = (size_t)(i0 + i) * Tp + j0 + c;
      float s = __fmul_rn(as[r], scale);
      if (bias_h) s = __fadd_rn(s, bias_h[off]);
      s = __fadd_rn(s, madd_s[c]);
      p = expf(__fsub_rn(s, lse_s[i]));
      t = __fmul_rn(p, __fsub_rn(ap[r], delta_s[i]));
      if (dbias_h) dbias_h[off] = first ? t : __fadd_rn(dbias_h[off], t);
    }
    tb_s[i * TS + c] = round_to<T>(__fmul_rn(t, scale));
    if (pb_s) pb_s[i * TS + c] = round_to<T>(p);
  }
}

template <int DH>
constexpr size_t dq_smem() {
  return ((size_t)2 * QT * (DH + 4) + 2 * KC * (DH + 4) + QT * (KC + 4) + 2 * QT + KC) *
         sizeof(float);
}

template <int DH>
constexpr size_t dkv_smem() {
  return ((size_t)2 * KT * (DH + 4) + 2 * QC * (DH + 4) + 2 * QC * (KT + 4) + 2 * QC + KT) *
         sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const int* __restrict__ kmask,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ bias, T* __restrict__ dq, float* dbias, int B, int Tp, int H,
          float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KS = DH + 4, TS = KC + 4;
  constexpr int NGD = THREADS / DH, RPD = QT / NGD;
  float* q_s = smem;              // [QT][KS]
  float* do_s = q_s + QT * KS;    // [QT][KS]
  float* k_s = do_s + QT * KS;    // [KC][KS]
  float* v_s = k_s + KC * KS;     // [KC][KS]
  float* tb_s = v_s + KC * KS;    // [QT][TS]
  float* lse_s = tb_s + QT * TS;  // [QT]
  float* delta_s = lse_s + QT;    // [QT]
  float* madd_s = delta_s + QT;   // [KC]
  const int q0 = blockIdx.x * QT, h = blockIdx.y;
  const int D = H * DH, nq = min(QT, Tp - q0);
  const int dc = threadIdx.x % DH, drg = threadIdx.x / DH;
  const float* bias_h = bias ? bias + (size_t)h * Tp * Tp : nullptr;
  float* dbias_h = dbias ? dbias + (size_t)h * Tp * Tp : nullptr;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t base = (size_t)b * Tp * D + (size_t)h * DH;
    const size_t rows = ((size_t)b * H + h) * Tp;
    __syncthreads();  // the previous batch row's readers are done
    stage_rows<T, DH>(q, base, D, q0, nq, QT, q_s);
    stage_rows<T, DH>(dout, base, D, q0, nq, QT, do_s);
    for (int i = threadIdx.x; i < QT; i += THREADS) {
      lse_s[i] = i < nq ? lse[rows + q0 + i] : 0.f;
      delta_s[i] = i < nq ? delta[rows + q0 + i] : 0.f;
    }
    float acc[RPD];
#pragma unroll
    for (int r = 0; r < RPD; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < Tp; j0 += KC) {
      const int nk = min(KC, Tp - j0);
      stage_rows<T, DH>(k, base, D, j0, nk, KC, k_s);
      stage_rows<T, DH>(v, base, D, j0, nk, KC, v_s);
      for (int j = threadIdx.x; j < KC; j += THREADS)
        madd_s[j] = j < nk && kmask[(size_t)b * Tp + j0 + j] > 0 ? 0.f : NEG;
      __syncthreads();
      score_tile<T, DH, QT, KC>(q_s, do_s, k_s, v_s, lse_s, delta_s, madd_s, bias_h, dbias_h,
                                b == 0, q0, j0, nq, nk, Tp, scale, tb_s, nullptr);
      __syncthreads();
      for (int j = 0; j < nk; ++j) {
        const float kv = k_s[j * KS + dc];
#pragma unroll
        for (int r = 0; r < RPD; ++r) acc[r] = fmaf(tb_s[(drg + r * NGD) * TS + j], kv, acc[r]);
      }
      __syncthreads();  // k_s and tb_s are restaged next
    }
#pragma unroll
    for (int r = 0; r < RPD; ++r) {
      const int i = drg + r * NGD;
      if (i < nq) dq[base + (size_t)(q0 + i) * D + dc] = from_f32<T>(acc[r]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const int* __restrict__ kmask,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ bias, T* __restrict__ dk, T* __restrict__ dv, int Tp, int H,
           float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KS = DH + 4, TS = KT + 4;
  constexpr int NGD = THREADS / DH, RPD = KT / NGD;
  float* k_s = smem;              // [KT][KS]
  float* v_s = k_s + KT * KS;     // [KT][KS]
  float* q_s = v_s + KT * KS;     // [QC][KS]
  float* do_s = q_s + QC * KS;    // [QC][KS]
  float* tb_s = do_s + QC * KS;   // [QC][TS]
  float* pb_s = tb_s + QC * TS;   // [QC][TS]
  float* lse_s = pb_s + QC * TS;  // [QC]
  float* delta_s = lse_s + QC;    // [QC]
  float* madd_s = delta_s + QC;   // [KT]
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH, nk = min(KT, Tp - k0);
  const int dc = threadIdx.x % DH, drg = threadIdx.x / DH;
  const size_t base = (size_t)b * Tp * D + (size_t)h * DH;
  const size_t rows = ((size_t)b * H + h) * Tp;
  const float* bias_h = bias ? bias + (size_t)h * Tp * Tp : nullptr;
  stage_rows<T, DH>(k, base, D, k0, nk, KT, k_s);
  stage_rows<T, DH>(v, base, D, k0, nk, KT, v_s);
  for (int j = threadIdx.x; j < KT; j += THREADS)
    madd_s[j] = j < nk && kmask[(size_t)b * Tp + k0 + j] > 0 ? 0.f : NEG;
  float adk[RPD], adv[RPD];
#pragma unroll
  for (int r = 0; r < RPD; ++r) adk[r] = adv[r] = 0.f;
  for (int i0 = 0; i0 < Tp; i0 += QC) {
    const int nq = min(QC, Tp - i0);
    stage_rows<T, DH>(q, base, D, i0, nq, QC, q_s);
    stage_rows<T, DH>(dout, base, D, i0, nq, QC, do_s);
    for (int i = threadIdx.x; i < QC; i += THREADS) {
      lse_s[i] = i < nq ? lse[rows + i0 + i] : 0.f;
      delta_s[i] = i < nq ? delta[rows + i0 + i] : 0.f;
    }
    __syncthreads();
    score_tile<T, DH, QC, KT>(q_s, do_s, k_s, v_s, lse_s, delta_s, madd_s, bias_h, nullptr,
                              false, i0, k0, nq, nk, Tp, scale, tb_s, pb_s);
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float qv = q_s[i * KS + dc], ov = do_s[i * KS + dc];
#pragma unroll
      for (int r = 0; r < RPD; ++r) {
        const int j = drg + r * NGD;
        adv[r] = fmaf(pb_s[i * TS + j], ov, adv[r]);
        adk[r] = fmaf(tb_s[i * TS + j], qv, adk[r]);
      }
    }
    __syncthreads();  // q_s, do_s, tb_s and pb_s are restaged next
  }
#pragma unroll
  for (int r = 0; r < RPD; ++r) {
    const int j = drg + r * NGD;
    if (j < nk) {
      dk[base + (size_t)(k0 + j) * D + dc] = from_f32<T>(adk[r]);
      dv[base + (size_t)(k0 + j) * D + dc] = from_f32<T>(adv[r]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const int* kmask, const float* lse, const float* bias,
                   void* dq, void* dk, void* dv, float* dbias, float* delta, int B, int Tp, int H,
                   float scale, cudaStream_t stream) {
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k);
  const T *vv = static_cast<const T*>(v), *oo = static_cast<const T*>(out);
  const T* dd = static_cast<const T*>(dout);
  const int n = B * H * Tp;
  delta_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(oo, dd, delta, B, Tp, H,
                                                                      DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kq = dq_kernel<T, DH>;
  e = uasr_set_smem(kq, dq_smem<DH>());
  if (e != cudaSuccess) return e;
  // with a bias, one CTA per query tile walks every batch row in order
  const dim3 gq((Tp + QT - 1) / QT, H, bias ? 1 : B);
  kq<<<gq, THREADS, dq_smem<DH>(), stream>>>(qq, kk, vv, dd, kmask, lse, delta, bias,
                                             static_cast<T*>(dq), dbias, B, Tp, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kkv = dkv_kernel<T, DH>;
  e = uasr_set_smem(kkv, dkv_smem<DH>());
  if (e != cudaSuccess) return e;
  const dim3 gkv((Tp + KT - 1) / KT, H, B);
  kkv<<<gkv, THREADS, dkv_smem<DH>(), stream>>>(qq, kk, vv, dd, kmask, lse, delta, bias,
                                                static_cast<T*>(dk), static_cast<T*>(dv), Tp, H,
                                                scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const int* kmask, const float* lse, const float* bias,
                     void* dq, void* dk, void* dv, float* dbias, float* delta, int B, int Tp,
                     int H, float scale, cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, delta, B, Tp,
                           H, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, delta, B, Tp,
                           H, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, delta, B, Tp,
                           H, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, delta, B,
                            Tp, H, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv [B, Tp, H * dh] of `dtype` (UASR_F32 or
// UASR_BF16); kmask [B, 1, Tp] int32; lse [B, H, Tp] f32; bias and dbias
// [H, Tp, Tp] f32, both null or both given; delta scratch [B, H, Tp] f32.
// Tp must be a multiple of 8 and dh one of 16, 32, 64, 128; scale is
// 1 / sqrt(dh) rounded to f32 by the caller.
UASR_EXPORT int uasr_mhsa_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const int* kmask, const float* lse,
                              const float* bias, void* dq, void* dk, void* dv, float* dbias,
                              float* delta, int B, int Tp, int H, int dh, float scale, int dtype,
                              void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || H < 1 || Tp < 8 || Tp % 8 || (!bias) != (!dbias)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return dispatch<float>(dh, q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, delta, B,
                           Tp, H, scale, s);
  if (dtype == UASR_BF16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias,
                                   delta, B, Tp, H, scale, s);
  return cudaErrorInvalidValue;
}
