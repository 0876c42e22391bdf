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
//   t = p (dp - delta);  d_bias[h] += t   (summed over b)
//   tb = round(t * scale);  dq = tb k_h;  dk = tb^T q_h
// round() is to q's dtype, products accumulate in f32, and dq, dk, dv are
// rounded to q's dtype once.
//
// Design: every product runs on wgmma (bf16 in, f32 accumulators in
// registers; mhsa_tiles.cuh), one warpgroup per CTA, 64-row tiles through
// a two-stage cp.async ring, so shared memory does not grow with Tp.
// - delta: one thread per (b, h, row).
// - dq (and d_bias): one CTA per (batch group, 64-row query tile, head),
//   walking its group's batch rows in ascending order and, for each, the
//   key tiles: S = Q K^T and dP = dO V^T, then p and t in registers, and
//   dQ += round(t * scale) K. With a bias the CTA also adds t into its
//   group's d_bias partial, which only it writes (set at the group's first
//   row, then read, added and written back for each later row: a fixed
//   order, no atomics). Group 0 writes d_bias itself; a last kernel adds
//   the other groups' partials into it in ascending group order, so two
//   launches give bit-identical d_bias. The group count depends only on
//   (B, Tp, H) and aims at ~512 CTAs (104 at B = 32, Tp = 400 with one
//   CTA per query tile walking all rows). Without a bias, one CTA per
//   batch row.
// - dk, dv: one CTA per (batch row, 64-key tile, head) walking the query
//   tiles: S^T = K Q^T and dP^T = V dO^T, p^T and t^T in registers, then
//   dV += round(p^T) dO and dK += round(t^T * scale) Q.
// The batch row (or group) is the fastest grid axis, so resident CTAs
// share the bias rows they read in L2. s and dp are formed in both passes.
// f32 runs the same passes with the products on CUDA cores.
//
// Bound: 10 B H Tp^2 dh operations (the TPU cost estimate; the key mask
// leaves fewer live) against ~8 B Tp H dh elements plus 2 H Tp^2 f32 of
// bias and d_bias: bytes in bf16 at B = 32, Tp = 400, 8 x 64 (~0.12 GB
// against ~26 GFLOP on tensor cores), operations in f32.

#include <algorithm>

#include "mhsa_tiles.cuh"

namespace {

using namespace mhsa;

constexpr int DELTA_THREADS = 256;
constexpr int GROUP_CTAS = 512;  // dq pass with a bias: CTAs to aim for

// batch rows per dq CTA with a bias; the group count is ceil(B / rows)
int group_rows(int B, int Tp, int H) {
  const int tiles = (Tp + TILE - 1) / TILE * H;
  const int groups = std::min(B, std::max(1, (GROUP_CTAS + tiles - 1) / tiles));
  return (B + groups - 1) / groups;
}

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int Tp, int H, int DH) {
  const size_t n = (size_t)B * H * Tp;
  for (size_t idx = (size_t)blockIdx.x * DELTA_THREADS + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * DELTA_THREADS) {
    const int i = idx % Tp;
    const size_t bh = idx / Tp;
    const int h = bh % H, b = bh / H;
    const size_t off = ((size_t)b * Tp + i) * H * DH + (size_t)h * DH;
    float acc = 0.f;
    for (int c = 0; c < DH; ++c) acc = fmaf(to_f32(dout[off + c]), to_f32(out[off + c]), acc);
    delta[idx] = acc;
  }
}

// d_bias += the other groups' partials [groups - 1][n], ascending
__global__ void __launch_bounds__(DELTA_THREADS)
dbias_sum_kernel(float4* __restrict__ dbias, const float4* __restrict__ part, size_t n4,
                 int parts) {
  for (size_t i = (size_t)blockIdx.x * DELTA_THREADS + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * DELTA_THREADS) {
    float4 acc = dbias[i];
    for (int g = 0; g < parts; ++g) {
      const float4 x = part[(size_t)g * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    dbias[i] = acc;
  }
}

template <typename T, int DH>
constexpr size_t pass_smem() {
  // two fixed tiles, the stages of two tiles and of 2 x TILE words (key
  // mask, or lse and delta), P staging (f32)
  using O = Ops<T, DH>;
  return (2 + 2 * STAGES) * O::TILE_BYTES + STAGES * 2 * TILE * sizeof(float) +
         O::SCRATCH_BYTES;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const int* __restrict__ kmask,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ bias, T* __restrict__ dq, float* dbias, float* dbias_part,
          int B, int Tp, int H, float scale, int rows_per_cta) {
  using O = Ops<T, DH>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + O::TILE_BYTES;
  uint8_t* k_s = do_s + O::TILE_BYTES;          // [STAGES]
  uint8_t* v_s = k_s + STAGES * O::TILE_BYTES;  // [STAGES]
  // [STAGES][TILE] key mask words, in the [STAGES][2 TILE] words dkv_kernel uses
  int* km_s = reinterpret_cast<int*>(v_s + STAGES * O::TILE_BYTES);
  float* scratch = reinterpret_cast<float*>(km_s + STAGES * 2 * TILE);

  const int g = blockIdx.x, q0 = blockIdx.y * TILE, h = blockIdx.z;
  const int D = H * DH, nkt = (Tp + TILE - 1) / TILE;
  const int b_begin = g * rows_per_cta, b_end = min(B, b_begin + rows_per_cta);
  const float* bias_h = bias ? bias + (size_t)h * Tp * Tp : nullptr;
  float* db_h = nullptr;  // this group's d_bias (partial) for head h
  if (bias)
    db_h = (g == 0 ? dbias : dbias_part + (size_t)(g - 1) * H * Tp * Tp) + (size_t)h * Tp * Tp;
  const Frag f;
  const int row0 = q0 + f.r0, row1 = row0 + 8;

  for (int b = b_begin; b < b_end; ++b) {
    const size_t base = (size_t)b * Tp * D + (size_t)h * DH;
    const int* km_b = kmask + (size_t)b * Tp;
    auto load_kv = [&](int kt) {
      if (kt < nkt) {
        const int st = kt % STAGES, k0 = kt * TILE;
        O::load(k_s + st * O::TILE_BYTES, k + base + (size_t)k0 * D, D, Tp - k0);
        O::load(v_s + st * O::TILE_BYTES, v + base + (size_t)k0 * D, D, Tp - k0);
        load_row_chunk(km_s + st * TILE, km_b + k0, Tp - k0);
      }
      cp_commit();
    };
    O::load(q_s, q + base + (size_t)q0 * D, D, Tp - q0);  // join key tile 0's group
    O::load(do_s, dout + base + (size_t)q0 * D, D, Tp - q0);
    for (int i = 0; i < STAGES - 1; ++i) load_kv(i);
    const size_t rows = ((size_t)b * H + h) * Tp;
    const float lse0 = row0 < Tp ? lse[rows + row0] : 0.f;
    const float lse1 = row1 < Tp ? lse[rows + row1] : 0.f;
    const float dl0 = row0 < Tp ? delta[rows + row0] : 0.f;
    const float dl1 = row1 < Tp ? delta[rows + row1] : 0.f;
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      load_kv(kt + STAGES - 1);
      cp_wait<STAGES - 1>();
      fence_async_smem();
      __syncthreads();
      const int st = kt % STAGES, k0 = kt * TILE;
      float s[32], dp[32];
      O::begin(s, dp);
      O::nt(s, q_s, k_s + st * O::TILE_BYTES);
      O::nt(dp, do_s, v_s + st * O::TILE_BYTES);
      O::commit();
      // this thread's bias pairs and, after the group's first row, its
      // d_bias partial so far, loaded while the products run
      float2 bv[16], prev[16];
      const bool add = db_h && b != b_begin;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 8 * j + f.c;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? row1 : row0;
          const bool in = col < Tp && row < Tp;
          const size_t off = (size_t)row * Tp + col;
          bv[2 * j + r] = bias_h && in ? *reinterpret_cast<const float2*>(bias_h + off)
                                       : make_float2(0.f, 0.f);
          prev[2 * j + r] = add && in ? *reinterpret_cast<const float2*>(db_h + off)
                                      : make_float2(0.f, 0.f);
        }
      }
      O::wait(s, dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + f.c + e;
          const float madd = k0 + col < Tp ? (km_s[st * TILE + col] > 0 ? 0.f : NEG) : -INFINITY;
          const float b0 = e ? bv[2 * j].y : bv[2 * j].x;
          const float b1 = e ? bv[2 * j + 1].y : bv[2 * j + 1].x;
          float& x0 = s[4 * j + e];
          float& x1 = s[4 * j + 2 + e];
          x0 = __fadd_rn(__fadd_rn(__fmul_rn(x0, scale), b0), madd);
          x1 = __fadd_rn(__fadd_rn(__fmul_rn(x1, scale), b1), madd);
          // t = p (dp - delta), kept in s
          x0 = __fmul_rn(expf(__fsub_rn(x0, lse0)), __fsub_rn(dp[4 * j + e], dl0));
          x1 = __fmul_rn(expf(__fsub_rn(x1, lse1)), __fsub_rn(dp[4 * j + 2 + e], dl1));
        }
      if (db_h) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = k0 + 8 * j + f.c;
          if (col >= Tp) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? row1 : row0;
            if (row >= Tp) continue;
            float2 t = make_float2(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
            if (add) {
              const float2 old = prev[2 * j + r];
              t = make_float2(__fadd_rn(old.x, t.x), __fadd_rn(old.y, t.y));
            }
            *reinterpret_cast<float2*>(db_h + (size_t)row * Tp + col) = t;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
      typename O::PFrag tf;
      O::round_frag(tf, s);
      O::begin(acc);
      O::rs(acc, tf, k_s + st * O::TILE_BYTES, scratch);
      O::commit();
      O::wait(acc);
      __syncthreads();  // stage st is refilled at the next step, q_s and do_s at the next row
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const size_t col = base + 8 * j + f.c;
      if (row0 < Tp) store_pair(dq + col + (size_t)row0 * D, acc[4 * j], acc[4 * j + 1]);
      if (row1 < Tp) store_pair(dq + col + (size_t)row1 * D, acc[4 * j + 2], acc[4 * j + 3]);
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
  using O = Ops<T, DH>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + O::TILE_BYTES;
  uint8_t* q_s = v_s + O::TILE_BYTES;            // [STAGES]
  uint8_t* do_s = q_s + STAGES * O::TILE_BYTES;  // [STAGES]
  float* ld_s = reinterpret_cast<float*>(do_s + STAGES * O::TILE_BYTES);  // [STAGES][lse, delta]
  float* scratch = ld_s + STAGES * 2 * TILE;

  const int b = blockIdx.x, k0 = blockIdx.y * TILE, h = blockIdx.z;
  const int D = H * DH, nqt = (Tp + TILE - 1) / TILE;
  const size_t base = (size_t)b * Tp * D + (size_t)h * DH;
  const size_t rows = ((size_t)b * H + h) * Tp;
  const float* bias_h = bias ? bias + (size_t)h * Tp * Tp : nullptr;
  const Frag f;
  const int key0 = k0 + f.r0, key1 = key0 + 8;  // this thread's rows are keys

  auto load_q = [&](int it) {
    if (it < nqt) {
      const int st = it % STAGES, i0 = it * TILE;
      O::load(q_s + st * O::TILE_BYTES, q + base + (size_t)i0 * D, D, Tp - i0);
      O::load(do_s + st * O::TILE_BYTES, dout + base + (size_t)i0 * D, D, Tp - i0);
      load_row_chunk(ld_s + st * 2 * TILE, lse + rows + i0, Tp - i0);
      load_row_chunk(ld_s + st * 2 * TILE + TILE, delta + rows + i0, Tp - i0);
    }
    cp_commit();
  };
  O::load(k_s, k + base + (size_t)k0 * D, D, Tp - k0);  // join query tile 0's group
  O::load(v_s, v + base + (size_t)k0 * D, D, Tp - k0);
  for (int i = 0; i < STAGES - 1; ++i) load_q(i);
  const int* km_b = kmask + (size_t)b * Tp;
  const float madd0 = key0 < Tp ? (km_b[key0] > 0 ? 0.f : NEG) : -INFINITY;
  const float madd1 = key1 < Tp ? (km_b[key1] > 0 ? 0.f : NEG) : -INFINITY;
  float adk[DH / 2], adv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) adk[i] = adv[i] = 0.f;

  for (int it = 0; it < nqt; ++it) {
    load_q(it + STAGES - 1);
    cp_wait<STAGES - 1>();
    fence_async_smem();
    __syncthreads();
    const int st = it % STAGES, i0 = it * TILE;
    const float* lse_s = ld_s + st * 2 * TILE;
    float s[32], dp[32];
    O::begin(s, dp);
    O::nt(s, k_s, q_s + st * O::TILE_BYTES);   // S^T: rows keys, columns queries
    O::nt(dp, v_s, do_s + st * O::TILE_BYTES);  // dP^T
    O::commit();
    float bv[32];  // bias[h, query, key] at this thread's (key row, query column) pairs
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = i0 + 8 * j + f.c + e;
        const bool ok = bias_h && qi < Tp;
        bv[4 * j + e] = ok && key0 < Tp ? bias_h[(size_t)qi * Tp + key0] : 0.f;
        bv[4 * j + 2 + e] = ok && key1 < Tp ? bias_h[(size_t)qi * Tp + key1] : 0.f;
      }
    O::wait(s, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + f.c + e;
        const bool live = i0 + col < Tp;  // padded query rows give nothing
        const float ls = lse_s[col], dl = lse_s[TILE + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float sc = __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), bv[i]), r ? madd1 : madd0);
          const float p = live ? expf(__fsub_rn(sc, ls)) : 0.f;
          s[i] = p;
          dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], dl)), scale);
        }
      }
    typename O::PFrag pf, tf;
    O::round_frag(pf, s);
    O::round_frag(tf, dp);
    O::begin(adv, adk);
    O::rs(adv, pf, do_s + st * O::TILE_BYTES, scratch);
    O::rs(adk, tf, q_s + st * O::TILE_BYTES, scratch);
    O::commit();
    O::wait(adv, adk);
    __syncthreads();  // stage st is refilled at the next step
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const size_t col = base + 8 * j + f.c;
    if (key0 < Tp) {
      store_pair(dk + col + (size_t)key0 * D, adk[4 * j], adk[4 * j + 1]);
      store_pair(dv + col + (size_t)key0 * D, adv[4 * j], adv[4 * j + 1]);
    }
    if (key1 < Tp) {
      store_pair(dk + col + (size_t)key1 * D, adk[4 * j + 2], adk[4 * j + 3]);
      store_pair(dv + col + (size_t)key1 * D, adv[4 * j + 2], adv[4 * j + 3]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const int* kmask, const float* lse, const float* bias,
                   void* dq, void* dk, void* dv, float* dbias, float* dbias_part, float* delta,
                   int B, int Tp, int H, float scale, cudaStream_t stream) {
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k);
  const T *vv = static_cast<const T*>(v), *oo = static_cast<const T*>(out);
  const T* dd = static_cast<const T*>(dout);
  const int n = B * H * Tp, tiles = (Tp + TILE - 1) / TILE;
  delta_kernel<T><<<(n + DELTA_THREADS - 1) / DELTA_THREADS, DELTA_THREADS, 0, stream>>>(
      oo, dd, delta, B, Tp, H, DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr size_t smem = pass_smem<T, DH>();
  auto kq = dq_kernel<T, DH>;
  e = uasr_set_smem(kq, smem);
  if (e != cudaSuccess) return e;
  const int rows = bias ? group_rows(B, Tp, H) : 1;
  const int groups = (B + rows - 1) / rows;
  kq<<<dim3(groups, tiles, H), THREADS, smem, stream>>>(
      qq, kk, vv, dd, kmask, lse, delta, bias, static_cast<T*>(dq), dbias, dbias_part, B, Tp, H,
      scale, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (bias && groups > 1) {
    const size_t n4 = (size_t)H * Tp * Tp / 4;
    const int blocks = (int)std::min<size_t>((n4 + DELTA_THREADS - 1) / DELTA_THREADS, 4096);
    dbias_sum_kernel<<<blocks, DELTA_THREADS, 0, stream>>>(
        reinterpret_cast<float4*>(dbias), reinterpret_cast<const float4*>(dbias_part), n4,
        groups - 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  auto kkv = dkv_kernel<T, DH>;
  e = uasr_set_smem(kkv, smem);
  if (e != cudaSuccess) return e;
  kkv<<<dim3(B, tiles, H), THREADS, smem, stream>>>(qq, kk, vv, dd, kmask, lse, delta, bias,
                                                    static_cast<T*>(dk), static_cast<T*>(dv),
                                                    Tp, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const int* kmask, const float* lse, const float* bias,
                     void* dq, void* dk, void* dv, float* dbias, float* dbias_part, float* delta,
                     int B, int Tp, int H, float scale, cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, dbias_part,
                           delta, B, Tp, H, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, dbias_part,
                           delta, B, Tp, H, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, dbias_part,
                           delta, B, Tp, H, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias, dbias_part,
                            delta, B, Tp, H, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// With a bias: the number of d_bias partials K6-bwd writes at (B, Tp, H),
// the groups of its dq pass; the caller passes uasr_mhsa_bwd a scratch of
// (groups - 1) [H, Tp, Tp] f32 partials.
UASR_EXPORT int uasr_mhsa_bwd_groups(int B, int Tp, int H) {
  if (B < 1 || H < 1 || Tp < 1) return 1;
  const int rows = group_rows(B, Tp, H);
  return (B + rows - 1) / rows;
}

// q, k, v, out, dout, dq, dk, dv [B, Tp, H * dh] of `dtype` (UASR_F32 or
// UASR_BF16); kmask [B, 1, Tp] int32; lse [B, H, Tp] f32; bias and dbias
// [H, Tp, Tp] f32, both null or both given; dbias_part the
// (uasr_mhsa_bwd_groups - 1) partials' scratch (null without a bias or with
// one group); delta scratch [B, H, Tp] f32. Tp must be a multiple of 8 and
// dh one of 16, 32, 64, 128; scale is 1 / sqrt(dh) rounded to f32 by the
// caller.
UASR_EXPORT int uasr_mhsa_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const int* kmask, const float* lse,
                              const float* bias, void* dq, void* dk, void* dv, float* dbias,
                              float* dbias_part, float* delta, int B, int Tp, int H, int dh,
                              float scale, int dtype, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || H < 1 || H > 65535 || Tp < 8 || Tp % 8 || (!bias) != (!dbias) ||
      (bias && !dbias_part && uasr_mhsa_bwd_groups(B, Tp, H) > 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UASR_F32)
    return dispatch<float>(dh, q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias,
                           dbias_part, delta, B, Tp, H, scale, s);
  if (dtype == UASR_BF16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, out, dout, kmask, lse, bias, dq, dk, dv, dbias,
                                   dbias_part, delta, B, Tp, H, scale, s);
  return cudaErrorInvalidValue;
}
