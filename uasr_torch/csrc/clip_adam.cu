// K-norm and K-adam: the global-norm clip and Adam of ClipAdam over every
// leaf of a model in two launches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optax's clip and Adam to
// XLA, which fuses them. Without these kernels the port's update was some
// 19 elementwise launches a leaf and a blocking copy of Adam's bias
// corrections, so the host paced the device through the whole update.
//
// Leaves are passed by value as a LeafTable in the kernels' parameters
// (p, g, m, v and the element count of up to TABLE_LEAVES leaves), as
// apex's multi-tensor apply does: nothing is copied to the card, so the
// update neither synchronises nor waits. Each leaf is cut into chunks of
// CHUNK elements; chunk_start is the prefix of the leaves' chunk counts,
// and a CTA walks the table's chunks with a grid stride, finding a chunk's
// leaf by binary search. More leaves than a table holds take one more
// launch of each kernel per table (uasr_torch/ops/cuda_adam.py plans them).
//
// K-norm: each CTA writes two partial sums of g^2 in f32, over the sharded
// and the replicated leaves (a ShardPlan's split), to partials[2 (part0 +
// CTA)]; the last CTA to finish, across all of an update's K-norm launches
// (a counter it resets to 0), sums the partials in index order and writes
// out[0] (sharded), out[1] (replicated) and out[2] = sqrt(out[1] +
// out[0]). Every sum runs in a fixed order, so the same inputs give the
// same bits on every run.
//
// K-adam: per element, with keep = norm < max_norm read from the device,
//   g  = keep ? g : (g / norm) * max_norm
//   m  = m * b1 + (1 - b1) * g
//   v  = v * b2 + (1 - b2) * (g * g)
//   p  = p + ((m / bc1) / (sqrt(v / bc2) + eps)) * step_size
// in optax's order, every operation rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into an FMA), as
// PyTorch's separate elementwise ops round them. f32 leaves below the clip
// therefore come out bit for bit as the per-leaf plain version's. bf16
// parameters or gradients are read into f32 and a bf16 parameter rounded
// once, after the add. A leaf whose four f32 arrays are 16-byte aligned
// moves float4s; chunks start at multiples of CHUNK, so only a leaf's last
// chunk has a scalar tail.
//
// Bound: bytes. K-adam reads g, p, m, v and writes p, m, v: 28 bytes an
// f32 element, 421 MB at the librispeech BiGRU's 15.03 M parameters, 0.126
// ms at 3.35 TB/s; K-norm reads g once more (60 MB, 0.018 ms).

#include "common.cuh"

constexpr int TABLE_LEAVES = 64;
constexpr int CHUNK = 4096;  // elements, a multiple of 4

struct LeafTable {
  void* p[TABLE_LEAVES];
  const void* g[TABLE_LEAVES];
  float* m[TABLE_LEAVES];
  float* v[TABLE_LEAVES];
  long long n[TABLE_LEAVES];
  int chunk_start[TABLE_LEAVES + 1];
  unsigned char flags[TABLE_LEAVES];
  int n_leaves;
};

struct AdamScalars {
  float max_norm, b1, one_minus_b1, b2, one_minus_b2, eps, bc1, bc2, step_size;
};

// kernel parameters beyond the table: K-norm's partials, part0,
// total_parts, counter and out; K-adam's norm and scalars
static_assert(sizeof(LeafTable) + 64 <= 4096, "the leaf table must fit the kernel parameters");

namespace {

constexpr int THREADS = 256;

enum { P_BF16 = 1, G_BF16 = 2, SHARDED = 4, VEC4 = 8 };

struct Span {
  int leaf;
  long long start, len;
};

__device__ __forceinline__ Span chunk_span(const LeafTable& t, int c) {
  int lo = 0, hi = t.n_leaves - 1;  // the last leaf whose chunk_start <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  const long long start = static_cast<long long>(c - t.chunk_start[lo]) * CHUNK;
  return {lo, start, min(static_cast<long long>(CHUNK), t.n[lo] - start)};
}

__device__ __forceinline__ float load_f32(const void* base, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

// the sum of `x` over the CTA, in a fixed order; every thread gets it
__device__ __forceinline__ float cta_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` free for reuse
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(THREADS)
    norm_kernel(const LeafTable t, float* partials, int part0, int total_parts,
                unsigned* counter, float* out) {
  __shared__ float red[THREADS / 32];
  __shared__ bool last;
  float acc[2] = {0.f, 0.f};  // sharded, replicated
  const int nchunks = t.chunk_start[t.n_leaves];
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const Span s = chunk_span(t, c);
    const unsigned char f = t.flags[s.leaf];
    float sum = 0.f;
    long long i = threadIdx.x;
    if (f & VEC4) {
      const float4* g4 = reinterpret_cast<const float4*>(
          static_cast<const float*>(t.g[s.leaf]) + s.start);
      const long long n4 = s.len >> 2;
      for (; i < n4; i += THREADS) {
        const float4 x = g4[i];
        sum = fmaf(x.x, x.x, sum);
        sum = fmaf(x.y, x.y, sum);
        sum = fmaf(x.z, x.z, sum);
        sum = fmaf(x.w, x.w, sum);
      }
      i = (n4 << 2) + threadIdx.x;
    }
    for (; i < s.len; i += THREADS) {
      const float x = load_f32(t.g[s.leaf], s.start + i, f & G_BF16);
      sum = fmaf(x, x, sum);
    }
    acc[(f & SHARDED) ? 0 : 1] += sum;
  }
  const float a0 = cta_sum(acc[0], red), a1 = cta_sum(acc[1], red);
  if (threadIdx.x == 0) {
    partials[2 * (part0 + blockIdx.x)] = a0;
    partials[2 * (part0 + blockIdx.x) + 1] = a1;
    __threadfence();
    last = atomicAdd(counter, 1u) == static_cast<unsigned>(total_parts - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s0 = 0.f, s1 = 0.f;
  for (int k = threadIdx.x; k < total_parts; k += THREADS) {
    s0 += __ldcg(partials + 2 * k);
    s1 += __ldcg(partials + 2 * k + 1);
  }
  s0 = cta_sum(s0, red);
  s1 = cta_sum(s1, red);
  if (threadIdx.x == 0) {
    out[0] = s0;
    out[1] = s1;
    out[2] = __fsqrt_rn(__fadd_rn(s1, s0));
    *counter = 0u;
  }
}

__device__ __forceinline__ void adam_step(float& p, float g, float& m, float& v, float norm,
                                          bool keep, const AdamScalars& a) {
  if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), a.max_norm);
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(g, g), a.one_minus_b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fdiv_rn(m, a.bc1), den), a.step_size));
}

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const LeafTable t, const float* norm_ptr, const AdamScalars a) {
  const float norm = *norm_ptr;
  const bool keep = norm < a.max_norm;
  const int nchunks = t.chunk_start[t.n_leaves];
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const Span s = chunk_span(t, c);
    const unsigned char f = t.flags[s.leaf];
    float* m = t.m[s.leaf] + s.start;
    float* v = t.v[s.leaf] + s.start;
    long long i = threadIdx.x;
    if (f & VEC4) {
      float4* p4 = reinterpret_cast<float4*>(static_cast<float*>(t.p[s.leaf]) + s.start);
      const float4* g4 = reinterpret_cast<const float4*>(
          static_cast<const float*>(t.g[s.leaf]) + s.start);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      const long long n4 = s.len >> 2;
      for (; i < n4; i += THREADS) {
        float4 pp = p4[i], mm = m4[i], vv = v4[i];
        const float4 gg = g4[i];
        adam_step(pp.x, gg.x, mm.x, vv.x, norm, keep, a);
        adam_step(pp.y, gg.y, mm.y, vv.y, norm, keep, a);
        adam_step(pp.z, gg.z, mm.z, vv.z, norm, keep, a);
        adam_step(pp.w, gg.w, mm.w, vv.w, norm, keep, a);
        p4[i] = pp;
        m4[i] = mm;
        v4[i] = vv;
      }
      i = (n4 << 2) + threadIdx.x;
    }
    const bool pb = f & P_BF16;
    for (; i < s.len; i += THREADS) {
      float pv = load_f32(t.p[s.leaf], s.start + i, pb);
      adam_step(pv, load_f32(t.g[s.leaf], s.start + i, f & G_BF16), m[i], v[i], norm, keep, a);
      if (pb)
        static_cast<__nv_bfloat16*>(t.p[s.leaf])[s.start + i] = __float2bfloat16_rn(pv);
      else
        static_cast<float*>(t.p[s.leaf])[s.start + i] = pv;
    }
  }
}

int blocks_per_sm(const void* kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// The layout the Python wrapper must mirror: sizeof(LeafTable), the
// table's capacity and the chunk length.
UASR_EXPORT int uasr_clip_adam_layout(int* table_bytes, int* table_leaves, int* chunk) {
  *table_bytes = static_cast<int>(sizeof(LeafTable));
  *table_leaves = TABLE_LEAVES;
  *chunk = CHUNK;
  return 0;
}

// *norm_ctas and *adam_ctas receive the most CTAs of each kernel that are
// resident at once on `device` (SMs times CTAs per SM): the wrapper's
// grids are at most these.
UASR_EXPORT int uasr_clip_adam_plan(int device, int* norm_ctas, int* adam_ctas) {
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  *norm_ctas = sms * blocks_per_sm(reinterpret_cast<const void*>(norm_kernel));
  *adam_ctas = sms * blocks_per_sm(reinterpret_cast<const void*>(adam_kernel));
  if (*norm_ctas < 1 || *adam_ctas < 1) return cudaErrorInvalidConfiguration;
  return cudaGetLastError();
}

// K-norm over one table: `grid` CTAs write partials[2 part0 .. 2 (part0 +
// grid)); the last of `total_parts` CTAs (across the update's launches)
// writes out[0..2] and resets *counter, which starts at 0.
UASR_EXPORT int uasr_clip_adam_norm(const LeafTable* table, float* partials, int part0, int grid,
                                    int total_parts, unsigned* counter, float* out, void* stream,
                                    int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (table->n_leaves < 1 || table->n_leaves > TABLE_LEAVES || grid < 1 || part0 < 0 ||
      part0 + grid > total_parts)
    return cudaErrorInvalidValue;
  norm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, partials, part0, total_parts, counter, out);
  return cudaGetLastError();
}

// K-adam over one table, `grid` CTAs, the global norm read from *norm.
UASR_EXPORT int uasr_clip_adam_update(const LeafTable* table, const float* norm, float max_norm,
                                      float b1, float one_minus_b1, float b2, float one_minus_b2,
                                      float eps, float bc1, float bc2, float step_size, int grid,
                                      void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (table->n_leaves < 1 || table->n_leaves > TABLE_LEAVES || grid < 1)
    return cudaErrorInvalidValue;
  const AdamScalars a{max_norm, b1, one_minus_b1, b2, one_minus_b2, eps, bc1, bc2, step_size};
  adam_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*table, norm, a);
  return cudaGetLastError();
}
