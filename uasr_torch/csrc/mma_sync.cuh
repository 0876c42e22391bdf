// Warp-level tensor-core products (mma.sync) of the grouped GRU kernels
// (K5's per-step product in gru_fwd.cu, gru_bwd.cu's coefficient kernel and
// the reverse chain of gru_bwd_chain.cuh), in f32 as 3xTF32 and in bf16
// directly.
//
// One product step is d[16 x 8] += a[16 x K_STEP] b[K_STEP x 8] (f32
// accumulation), K_STEP = 8 (tf32) or 16 (bf16). Lane l of the warp (g =
// l / 4, q = l % 4) holds
//   d: (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)
//   a (f32): (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
//   b (f32): (q, g), (q + 4, g)
//   a (bf16 pairs): (g, 2q..), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..)
//   b (bf16 pairs): (2q.., g), (2q + 8.., g)
//
// f32 as 3xTF32: each operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (x - hi is exact in f32), and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi: the dropped a_lo b_lo and the two
// roundings leave ~2^-21 of |a||b| per product, against single-pass
// TF32's 2^-11, which misses the f32 bars. A raw f32 register is never
// fed to a tf32 mma (the hardware would drop its low bits unrounded).
// rna_tf32 rounds as cvt.rna.tf32.f32 does (to nearest, ties away from
// zero), by two full-rate integer operations on the bits:
// (x + 2^12) & ~(2^13 - 1), in place of a conversion.
#pragma once

#include "common.cuh"

namespace mma {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// operand registers of one product step, split for 3xTF32 in f32
template <typename T>
struct Op;

template <>
struct Op<float> {
  static constexpr int K_STEP = 8;
  uint32_t hi, lo;
  __device__ __forceinline__ void set(float x) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  }
};

template <>
struct Op<__nv_bfloat16> {
  static constexpr int K_STEP = 16;
  uint32_t v;  // two bf16, the lower k in the low half
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment of a row-major [16][K_STEP] slice at `p` (row pitch `ld`
// elements): the slice's first row and column.
__device__ __forceinline__ void load_a(Op<float> (&a)[4], const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  a[0].set(p[g * ld + q]);
  a[1].set(p[(g + 8) * ld + q]);
  a[2].set(p[g * ld + q + 4]);
  a[3].set(p[(g + 8) * ld + q + 4]);
}
__device__ __forceinline__ void load_a(Op<__nv_bfloat16> (&a)[4], const __nv_bfloat16* p,
                                       int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  a[0].v = *reinterpret_cast<const uint32_t*>(p + g * ld + 2 * q);
  a[1].v = *reinterpret_cast<const uint32_t*>(p + (g + 8) * ld + 2 * q);
  a[2].v = *reinterpret_cast<const uint32_t*>(p + g * ld + 2 * q + 8);
  a[3].v = *reinterpret_cast<const uint32_t*>(p + (g + 8) * ld + 2 * q + 8);
}

// B fragment of a [K_STEP][8] slice stored k-major (b[k][n] at p[k * ld + n]).
__device__ __forceinline__ void load_b_kn(Op<float> (&b)[2], const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  b[0].set(p[q * ld + g]);
  b[1].set(p[(q + 4) * ld + g]);
}
__device__ __forceinline__ void load_b_kn(Op<__nv_bfloat16> (&b)[2], const __nv_bfloat16* p,
                                          int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  b[0].v = s[2 * q * ld + g] | (uint32_t)s[(2 * q + 1) * ld + g] << 16;
  b[1].v = s[(2 * q + 8) * ld + g] | (uint32_t)s[(2 * q + 9) * ld + g] << 16;
}

// A and B fragments of two product steps (2 K_STEP elements of K) at once,
// with K permuted inside the pair so that each thread's share is 16
// contiguous bytes of a row: thread q takes elements 4q..4q+3 (f32) or
// 8q..8q+7 (bf16) of the pair. A and B use the same permutation, so the
// sum over K is unchanged. Row pitches of 16 mod 32 words keep these
// 16-byte loads free of bank conflicts. a[s], b[s]: product step s.
__device__ __forceinline__ void load_a2(Op<float> (&a)[2][4], const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float4 r0 = *reinterpret_cast<const float4*>(p + g * ld + 4 * q);
  const float4 r1 = *reinterpret_cast<const float4*>(p + (g + 8) * ld + 4 * q);
  a[0][0].set(r0.x), a[0][1].set(r1.x), a[0][2].set(r0.y), a[0][3].set(r1.y);
  a[1][0].set(r0.z), a[1][1].set(r1.z), a[1][2].set(r0.w), a[1][3].set(r1.w);
}
__device__ __forceinline__ void load_a2(Op<__nv_bfloat16> (&a)[2][4], const __nv_bfloat16* p,
                                        int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const uint4 r0 = *reinterpret_cast<const uint4*>(p + g * ld + 8 * q);
  const uint4 r1 = *reinterpret_cast<const uint4*>(p + (g + 8) * ld + 8 * q);
  a[0][0].v = r0.x, a[0][1].v = r1.x, a[0][2].v = r0.y, a[0][3].v = r1.y;
  a[1][0].v = r0.z, a[1][1].v = r1.z, a[1][2].v = r0.w, a[1][3].v = r1.w;
}
// B stored n-major (b[n][k] at p[n * ld + k])
__device__ __forceinline__ void load_b2(Op<float> (&b)[2][2], const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float4 w = *reinterpret_cast<const float4*>(p + g * ld + 4 * q);
  b[0][0].set(w.x), b[0][1].set(w.y), b[1][0].set(w.z), b[1][1].set(w.w);
}
__device__ __forceinline__ void load_b2(Op<__nv_bfloat16> (&b)[2][2], const __nv_bfloat16* p,
                                        int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const uint4 w = *reinterpret_cast<const uint4*>(p + g * ld + 8 * q);
  b[0][0].v = w.x, b[0][1].v = w.y, b[1][0].v = w.z, b[1][1].v = w.w;
}
// B stored k-major (b[k][n] at p[k * ld + n]), K permuted as load_b2 does
// (4 or 8 elements of one column, each 4-byte or 2-byte loads)
__device__ __forceinline__ void load_b2_kn(Op<float> (&b)[2][2], const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float* c = p + 4 * q * ld + g;
  b[0][0].set(c[0]), b[0][1].set(c[ld]), b[1][0].set(c[2 * ld]), b[1][1].set(c[3 * ld]);
}
__device__ __forceinline__ void load_b2_kn(Op<__nv_bfloat16> (&b)[2][2], const __nv_bfloat16* p,
                                           int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const unsigned short* c = reinterpret_cast<const unsigned short*>(p) + 8 * q * ld + g;
  b[0][0].v = c[0] | (uint32_t)c[ld] << 16;
  b[0][1].v = c[2 * ld] | (uint32_t)c[3 * ld] << 16;
  b[1][0].v = c[4 * ld] | (uint32_t)c[5 * ld] << 16;
  b[1][1].v = c[6 * ld] | (uint32_t)c[7 * ld] << 16;
}

// d + lo += a b. In f32 the two small TF32 products go into `lo` and the
// large one into `d` (two accumulators, so two chains of dependent mmas
// overlap; the caller adds them at the end; both may be the same array).
// In bf16 `lo` is untouched.
__device__ __forceinline__ void mma(float (&d)[4], float (&lo)[4], const Op<float> (&a)[4],
                                    const Op<float> (&b)[2]) {
  mma_tf32(lo, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(lo, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}
__device__ __forceinline__ void mma(float (&d)[4], float (&)[4], const Op<__nv_bfloat16> (&a)[4],
                                    const Op<__nv_bfloat16> (&b)[2]) {
  mma_bf16(d, a[0].v, a[1].v, a[2].v, a[3].v, b[0].v, b[1].v);
}

// f32 pairs of consecutive elements (8- or 4-byte aligned)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// the same through L2 only (a value written earlier in the same launch)
__device__ __forceinline__ float2 ld2_cg(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2_cg(const __nv_bfloat16* p) {
  const unsigned w = __ldcg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace mma
