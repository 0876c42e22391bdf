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
// The row max is exact (all scores of a row sit in shared memory before
// any exp), so e is rounded against the same m as on the TPU; an online
// softmax would round it against a running max.
//
// Design: one CTA of 256 threads per (query tile of QT = 32 rows, head,
// batch row). The CTA stages the tile's queries and then all Tp keys of
// its head (f32, rows padded to dh + 4 floats so neighbouring rows fall on
// other banks), computes the [QT, Tp] scores into shared memory (a thread
// per key, its QT dot products against broadcast query rows), takes each
// row's max, exp and sum with one warp per row, restages the buffer with
// V_h, and forms o with each thread holding QT * dh / 256 outputs of one
// column. Shared memory: Tp (dh + 4) + QT dh + QT Tp floats, so Tp is
// bounded (512 at dh = 64); the wrapper refuses more.
//
// Bound: 4 B H Tp^2 dh operations on bf16 inputs against ~4 B Tp H dh
// bytes: operations, on tensor cores. This kernel runs them on CUDA cores
// in f32; wgmma for QK^T and PV is later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QT = 32;  // query rows per CTA
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ kmask, const float* __restrict__ bias, T* out,
                float* lse, int Tp, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KS = DH + 4;  // padded row of the K / V buffer
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int SS = Tp;  // score row stride (Tp is a multiple of 8)
  float* kv_s = smem;                        // [Tp][KS] K_h, then V_h
  float* q_s = kv_s + (size_t)Tp * KS;       // [QT][DH]
  float* s_s = q_s + QT * DH;                // [QT][Tp] scores, then e
  float* madd_s = s_s + (size_t)QT * SS;     // [Tp] 0 or -1e30
  float* ml_s = madd_s + Tp;                 // [QT][2] row max and sum
  const int nq = min(QT, Tp - q0);
  const size_t base = (size_t)b * Tp * D + (size_t)h * DH;

  for (int i = threadIdx.x; i < QT * DH; i += THREADS) {
    const int r = i / DH, c = i - r * DH;
    q_s[i] = r < nq ? to_f32(q[base + (size_t)(q0 + r) * D + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < Tp * DH; i += THREADS) {
    const int r = i / DH, c = i - r * DH;
    kv_s[r * KS + c] = to_f32(k[base + (size_t)r * D + c]);
  }
  for (int j = threadIdx.x; j < Tp; j += THREADS)
    madd_s[j] = kmask[(size_t)b * Tp + j] > 0 ? 0.f : NEG;
  __syncthreads();

  // scores: thread per key j, all QT rows
  const float* bh = bias ? bias + ((size_t)h * Tp + q0) * Tp : nullptr;
  for (int j = threadIdx.x; j < Tp; j += THREADS) {
    float acc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i] = 0.f;
    const float* kr = kv_s + j * KS;
#pragma unroll 4
    for (int c = 0; c < DH; c += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_s + i * DH + c);
        acc[i] = fmaf(q4.x, k4.x, acc[i]);
        acc[i] = fmaf(q4.y, k4.y, acc[i]);
        acc[i] = fmaf(q4.z, k4.z, acc[i]);
        acc[i] = fmaf(q4.w, k4.w, acc[i]);
      }
    }
    const float ma = madd_s[j];
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      float sc = acc[i] * scale;
      if (bh && i < nq) sc += bh[(size_t)i * Tp + j];
      s_s[i * SS + j] = sc + ma;
    }
  }
  __syncthreads();

  // softmax statistics, one warp per row: exact max first, then
  // e = exp(s - m) summed in f32 and stored rounded to q's dtype
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < QT; i += THREADS / 32) {
    float* row = s_s + i * SS;
    float m = -INFINITY;
    for (int j = lane; j < Tp; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < Tp; j += 32) {
      const float e = expf(row[j] - m);
      l += e;
      row[j] = round_to<T>(e);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      ml_s[2 * i] = m;
      ml_s[2 * i + 1] = l;
    }
  }
  __syncthreads();  // K_h no longer read: restage the buffer with V_h
  for (int i = threadIdx.x; i < Tp * DH; i += THREADS) {
    const int r = i / DH, c = i - r * DH;
    kv_s[r * KS + c] = to_f32(v[base + (size_t)r * D + c]);
  }
  __syncthreads();

  // o = e @ V_h: thread owns column d of rows rg, rg + NG, ...
  constexpr int NG = THREADS / DH;  // row groups
  constexpr int RPT = QT / NG;      // rows per thread
  const int d = threadIdx.x % DH, rg = threadIdx.x / DH;
  float o[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) o[r] = 0.f;
  for (int j = 0; j < Tp; j += 4) {
    const float v0 = kv_s[(j + 0) * KS + d], v1 = kv_s[(j + 1) * KS + d];
    const float v2 = kv_s[(j + 2) * KS + d], v3 = kv_s[(j + 3) * KS + d];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 e4 = *reinterpret_cast<const float4*>(s_s + (rg + r * NG) * SS + j);
      o[r] = fmaf(e4.x, v0, o[r]);
      o[r] = fmaf(e4.y, v1, o[r]);
      o[r] = fmaf(e4.z, v2, o[r]);
      o[r] = fmaf(e4.w, v3, o[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg + r * NG;
    if (i < nq) out[base + (size_t)(q0 + i) * D + d] = from_f32<T>(o[r] / ml_s[2 * i + 1]);
  }
  for (int i = threadIdx.x; i < nq; i += THREADS)
    lse[((size_t)b * H + h) * Tp + q0 + i] = ml_s[2 * i] + logf(ml_s[2 * i + 1]);
}

template <int DH>
size_t smem_bytes(int Tp) {
  return ((size_t)Tp * (DH + 4) + QT * DH + (size_t)QT * Tp + Tp + 2 * QT) * sizeof(float);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kmask,
                   const float* bias, void* out, float* lse, int B, int Tp, int H, float scale,
                   cudaStream_t stream) {
  auto kernel = mhsa_fwd_kernel<T, DH>;
  const size_t smem = smem_bytes<DH>(Tp);
  cudaError_t e = uasr_set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tp + QT - 1) / QT, H, B);
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

// Shared memory (bytes) one CTA needs at (dh, Tp); 0 for an unsupported dh.
UASR_EXPORT long long uasr_mhsa_smem(int dh, int Tp) {
  switch (dh) {
    case 16: return (long long)smem_bytes<16>(Tp);
    case 32: return (long long)smem_bytes<32>(Tp);
    case 64: return (long long)smem_bytes<64>(Tp);
    case 128: return (long long)smem_bytes<128>(Tp);
  }
  return 0;
}

// q, k, v, out [B, Tp, H * dh] of `dtype` (UASR_F32 or UASR_BF16); kmask
// [B, 1, Tp] int32; bias [H, Tp, Tp] f32 or null; lse [B, H, Tp] f32.
// Tp must be a multiple of 8 and dh one of 16, 32, 64, 128; scale is
// 1 / sqrt(dh) rounded to f32 by the caller.
UASR_EXPORT int uasr_mhsa_fwd(const void* q, const void* k, const void* v, const int* kmask,
                              const float* bias, void* out, float* lse, int B, int Tp, int H,
                              int dh, float scale, int dtype, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || H < 1 || Tp < 8 || Tp % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32) return dispatch<float>(dh, q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
  if (dtype == UASR_BF16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, kmask, bias, out, lse, B, Tp, H, scale, s);
  return cudaErrorInvalidValue;
}
