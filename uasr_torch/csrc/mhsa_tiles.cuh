// Tiles and tensor-core products shared by K6 (mhsa_fwd.cu) and K6-bwd
// (mhsa_bwd.cu).
//
// Both kernels run one warpgroup (128 threads) per CTA over 64-row tiles
// of query and key rows, one head's column slice [64][dh] of a packed
// [B, Tp, H * dh] tensor. Two products cover every matrix product of the
// forward and the backward:
//   nt: d[64 x 64]  = A B^T, A and B [64][dh] tiles (QK^T, dO V^T, K Q^T, V dO^T)
//   rs: d[64 x dh] += P B,  P [64 x 64] in registers, B a [64][dh] tile (PV, P^T dO,
//                          T K, T^T Q)
// Results are f32 in wgmma's accumulator layout: thread t of the
// warpgroup (warp w = t / 32, lane l) holds rows r0 = 16 w + l / 4 and
// r0 + 8, columns 8 j + 2 (l % 4) and the next, as
//   d[4 j] (r0, c), d[4 j + 1] (r0, c + 1), d[4 j + 2] (r0 + 8, c), d[4 j + 3] (r0 + 8, c + 1)
// with c = 8 j + 2 (l % 4). That is also wgmma's register layout for the A
// operand, so a score fragment, rounded, feeds the next product directly.
//
// Each kernel streams the tiles it walks through a ring of STAGES
// shared-memory stages filled by cp.async, one commit group per step
// (empty past the last), so step i waits with cp_wait<STAGES - 1>. Three
// stages measured no faster than two on the H100 (PERF.md).
//
// Ops<bf16, dh>: tiles in wgmma's no-swizzle core-matrix layout (8 rows x
// 16 bytes contiguous; core matrices of one 8-column chunk stacked by row
// block, chunks 1024 bytes apart), filled by cp.async; nt is wgmma
// m64n64k16 with both operands K-major in shared memory, rs is wgmma
// m64n{dh}k16 with P from registers and the same tile read MN-major.
// Ops<float, dh>: tiles as rows padded to dh + 4 floats and the same two
// products on CUDA cores in f32 (TF32 would not hold the f32 bars), in
// the same fragment layout, so the kernels' softmax and gradient code is
// shared by both types.
#pragma once

#include "common.cuh"

namespace mhsa {

constexpr int TILE = 64;      // query or key rows per tile (wgmma's M)
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;     // depth of the cp.async rings
constexpr float NEG = -1e30f;

// make this thread's shared-memory writes visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes of each of the key mask's (or lse's, delta's) TILE entries from
// `src`, entries at or past `n` zero; 16 threads
__device__ __forceinline__ void load_row_chunk(void* dst, const void* src, int n) {
  const int i = threadIdx.x;
  if (i < TILE / 4)
    cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i, 4 * i < n);
}

struct Frag {  // this thread's rows and first column in the accumulator layout
  int r0, c;
  __device__ Frag()
      : r0(16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4), c(2 * (threadIdx.x % 4)) {}
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, LBO
// (byte offset between core matrices along K) and SBO (along M or N)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= A B^T: A [64 x 16] and B [64 x 16] K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B: A [64 x 16] in registers, B [16 x 16] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A [64 x 16] in registers, B [16 x 32] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A [64 x 16] in registers, B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A [64 x 16] in registers, B [16 x 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_m64n16(d, a, db);
  if constexpr (N == 32) wgmma_rs_m64n32(d, a, db);
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, db);
  if constexpr (N == 128) wgmma_rs_m64n128(d, a, db);
}

template <typename T, int DH>
struct Ops;

template <int DH>
struct Ops<__nv_bfloat16, DH> {
  using T = __nv_bfloat16;
  static constexpr int TILE_BYTES = TILE * DH * 2;
  static constexpr int SCRATCH_BYTES = 0;
  static constexpr uint32_t CHUNK = TILE * 16;  // bytes between 8-column chunks
  struct PFrag {
    uint32_t a[TILE / 16][4];  // bf16 pairs, one group of 4 per 16 columns
  };

  // rows [0, TILE) of `src` (row stride ld elements), rows >= n zero
  static __device__ __forceinline__ void load(uint8_t* dst, const T* src, int ld, int n) {
    constexpr int NCH = DH / 8;
#pragma unroll
    for (int i = threadIdx.x; i < TILE * NCH; i += THREADS) {
      const int rlo = i & 7, cb = (i >> 3) % NCH, rhi = (i >> 3) / NCH, row = 8 * rhi + rlo;
      cp_async16(dst + cb * CHUNK + rhi * 128 + rlo * 16,
                 row < n ? src + (size_t)row * ld + 8 * cb : src, row < n);
    }
  }
  // d = A B^T over DH: both tiles K-major (LBO: next chunk, SBO: next 8 rows)
  static __device__ __forceinline__ void nt(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(d, wgmma_desc(a + 2 * kk * CHUNK, CHUNK, 128),
                      wgmma_desc(b + 2 * kk * CHUNK, CHUNK, 128), kk > 0);
  }
  // d += P B: B's rows are the product's K, read MN-major (SBO: next
  // chunk of 8 columns, LBO: next 8 rows)
  static __device__ __forceinline__ void rs(float (&d)[DH / 2], const PFrag& p, const uint8_t* b,
                                            float*) {
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<DH>(d, p.a[kk], wgmma_desc(b + 256 * kk, 128, CHUNK));
  }
  // P rounded to bf16, in wgmma's A-register layout
  static __device__ __forceinline__ void round_frag(PFrag& p, const float (&x)[32]) {
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 v = __floats2bfloat162_rn(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
        p.a[kk][i] = *reinterpret_cast<uint32_t*>(&v);
      }
  }
  template <typename... A>
  static __device__ __forceinline__ void begin(A&... acc) {
    (fence_regs(acc), ...);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  }
  static __device__ __forceinline__ void commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  template <typename... A>
  static __device__ __forceinline__ void wait(A&... acc) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    (fence_regs(acc), ...);
  }
};

template <int DH>
struct Ops<float, DH> {
  using T = float;
  static constexpr int LD = DH + 4;  // padded row: neighbouring rows on other banks
  static constexpr int TILE_BYTES = TILE * LD * 4;
  static constexpr int PLD = TILE + 4;
  static constexpr int SCRATCH_BYTES = THREADS / 32 * 16 * PLD * 4;  // P, 16 rows per warp
  struct PFrag {
    float x[32];
  };

  static __device__ __forceinline__ void load(uint8_t* dst, const T* src, int ld, int n) {
    constexpr int NCH = DH / 4;
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll
    for (int i = threadIdx.x; i < TILE * NCH; i += THREADS) {
      const int row = i / NCH, cc = i % NCH;
      cp_async16(d + row * LD + 4 * cc, row < n ? src + (size_t)row * ld + 4 * cc : src, row < n);
    }
  }
  static __device__ __forceinline__ void nt(float (&d)[32], const uint8_t* a, const uint8_t* b) {
    const float* A = reinterpret_cast<const float*>(a);
    const float* B = reinterpret_cast<const float*>(b);
    const Frag f;
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
#pragma unroll 2
    for (int k = 0; k < DH; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + f.r0 * LD + k);
      const float4 a1 = *reinterpret_cast<const float4*>(A + (f.r0 + 8) * LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 bv = *reinterpret_cast<const float4*>(B + (8 * j + f.c + e) * LD + k);
          float& x0 = d[4 * j + e];
          float& x1 = d[4 * j + 2 + e];
          x0 = fmaf(a0.x, bv.x, x0); x0 = fmaf(a0.y, bv.y, x0);
          x0 = fmaf(a0.z, bv.z, x0); x0 = fmaf(a0.w, bv.w, x0);
          x1 = fmaf(a1.x, bv.x, x1); x1 = fmaf(a1.y, bv.y, x1);
          x1 = fmaf(a1.z, bv.z, x1); x1 = fmaf(a1.w, bv.w, x1);
        }
    }
  }
  // P goes through this warp's 16 rows of `scratch` to reach every column
  static __device__ __forceinline__ void rs(float (&d)[DH / 2], const PFrag& p, const uint8_t* b,
                                            float* scratch) {
    const float* B = reinterpret_cast<const float*>(b);
    const Frag f;
    const int lr = (threadIdx.x % 32) / 4;
    float* S = scratch + (threadIdx.x / 32) * 16 * PLD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        S[lr * PLD + 8 * j + f.c + e] = p.x[4 * j + e];
        S[(lr + 8) * PLD + 8 * j + f.c + e] = p.x[4 * j + 2 + e];
      }
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < TILE; ++k) {
      const float p0 = S[lr * PLD + k], p1 = S[(lr + 8) * PLD + k];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(B + k * LD + 8 * j + f.c);
        d[4 * j] = fmaf(p0, bv.x, d[4 * j]);
        d[4 * j + 1] = fmaf(p0, bv.y, d[4 * j + 1]);
        d[4 * j + 2] = fmaf(p1, bv.x, d[4 * j + 2]);
        d[4 * j + 3] = fmaf(p1, bv.y, d[4 * j + 3]);
      }
    }
    __syncwarp();  // S is rewritten by the next product
  }
  static __device__ __forceinline__ void round_frag(PFrag& p, const float (&x)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) p.x[i] = x[i];
  }
  template <typename... A>
  static __device__ __forceinline__ void begin(A&...) {}
  static __device__ __forceinline__ void commit() {}
  template <typename... A>
  static __device__ __forceinline__ void wait(A&...) {}
};

}  // namespace mhsa
