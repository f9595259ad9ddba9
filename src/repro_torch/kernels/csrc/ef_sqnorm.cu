// Per-row squared L2 norm of per-sample gradients, (B, N) -> (B,) fp32.
//
// Replaces the TPU kernel src/repro/kernels/ef_sqnorm.py:ef_sqnorm_pallas
// (_ef_kernel). Bound by bytes: every element is read once and costs two
// flops, far below the card's balance point, so the kernel is as fast as
// the bytes it keeps in flight. HBM at 3.35 TB/s wants some 25-30 KB in
// flight on each SM; a row of the main path runs from 2,048 elements (a
// norm's scale) to 786 M (an embedding).
//
// Design (kernels/ef_sqnorm.py:launch_plan sizes it from N, the dtype and
// the alignment alone, never from B or the card):
//  - one launch a call. A row is cut into ``ctas`` contiguous chunks, one
//    CTA each (a 1-D grid of B x ctas). Each CTA reduces its chunk with a
//    fixed butterfly (common.cuh:block_sum) and writes its partial; the
//    last CTA of the row to finish, found through an atomic ticket with a
//    __threadfence on both sides, folds the row's partials in chunk order
//    with the same butterfly, writes the output and resets its ticket to
//    0 (the wrapper's per-device, per-stream ticket buffer, shared with
//    paged_attention, is zeroed once when it is made). A row of one chunk
//    writes its output directly. No second kernel, no memset, no float
//    atomics: the same bits on every run, and a row of a (B, N) call has
//    the bits it has alone;
//  - bytes in flight: a thread issues UNROLL (4) independent 16-byte
//    loads a step, each into its own fp32 accumulator, the accumulators
//    added in a fixed pairwise order at the end. A row of up to 1,024
//    steps of 256 threads gets a CTA a step (a 29,696-element fp32 row is
//    8 CTAs, one HBM round trip each); a longer row takes 512-thread CTAs
//    (32 KB a step) of several steps, at most MAX_CTAS (1,024) a row, so
//    the last CTA's fold reads at most 4 partials a thread and the largest
//    rows run ~1,000 CTAs, every SM busy;
//  - rows that are unaligned or whose N is not a whole number of 16-byte
//    vectors take the scalar route (element loads, 8 a thread a step);
//  - offsets are 64-bit: 4 x 786.4 M elements pass 2^31.
// Unrolled 16-byte loads were kept over a cp.async.bulk/mbarrier ring. On
// a 25.7 M-element row, 8 loads a thread instead of 4, 256 or 512 threads
// and 98 to 3,136 CTAs all took the same time within 10%, so bytes in
// flight do not bound it: the launch and a cold round trip (a 2,048-
// element row, one load a thread, takes ~6 us) and, in chip_smoke.py's
// timer, the write-back of the dirty lines its L2 flush leaves (PERF.md
// § 6) do, and a ring would change neither. L1/L2 cache hints on the
// loads helped that row only against dirty L2 lines and cost the largest
// rows as much, so the loads are plain __ldg.
#include "common.cuh"

namespace {

constexpr int EF_MAX_THREADS = 512;

template <typename T, int VEC>
__device__ __forceinline__ float sq_add(const uint4& u, float acc) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_f(e[j]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

// independent loads a thread issues a step: 16-byte vectors, or elements
// on the scalar route (kernels/ef_sqnorm.py: UNROLL, SCALAR_UNROLL)
template <int VEC> constexpr int kUnroll = VEC > 1 ? 4 : 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(EF_MAX_THREADS)
ef_sqnorm_kernel(const T* __restrict__ g, long long n, long long chunk,
                 int ctas, float* __restrict__ partials,
                 int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ float sh[32];
  __shared__ int last;
  const long long row = blockIdx.x / ctas;
  const int c = (int)(blockIdx.x - row * ctas);
  const long long lo = (long long)c * chunk;
  const long long hi = (lo + chunk < n) ? lo + chunk : n;
  const T* base = g + row * n + lo;
  const int nt = blockDim.x;
  constexpr int UNROLL = kUnroll<VEC>;
  float acc[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) acc[k] = 0.f;

  if constexpr (VEC > 1) {
    // lo is a multiple of chunk (whole steps) and n % VEC == 0: the chunk
    // is whole 16-byte vectors from a 16-byte aligned start
    const uint4* vb = reinterpret_cast<const uint4*>(base);
    const long long nv = (hi - lo) / VEC;
    const long long step = (long long)nt * UNROLL;
    const long long full = nv - nv % step;
    for (long long s = threadIdx.x; s < full; s += step) {
      uint4 u[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) u[k] = __ldg(vb + s + k * nt);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) acc[k] = sq_add<T, VEC>(u[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long j = full + threadIdx.x + k * nt;
      if (j < nv) acc[k] = sq_add<T, VEC>(__ldg(vb + j), acc[k]);
    }
  } else {
    const long long m = hi - lo;
    const long long step = (long long)nt * UNROLL;
    const long long full = m - m % step;
    for (long long s = threadIdx.x; s < full; s += step) {
      float f[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) f[k] = to_f(base[s + k * nt]);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) acc[k] = fmaf(f[k], f[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long j = full + threadIdx.x + k * nt;
      if (j < m) {
        const float f = to_f(base[j]);
        acc[k] = fmaf(f, f, acc[k]);
      }
    }
  }
  // the accumulators in a fixed pairwise order, then the block's butterfly
#pragma unroll
  for (int w = UNROLL / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int k = 0; k < w; ++k) acc[k] += acc[k + w];
  }
  const float s = block_sum(acc[0], sh);
  if (ctas == 1) {
    if (threadIdx.x == 0) out[row] = s;
    return;
  }

  // more than one chunk: the last CTA of the row folds the partials in
  // chunk order and resets the ticket
  if (threadIdx.x == 0) {
    partials[row * ctas + c] = s;
    __threadfence();
    last = atomicAdd(tickets + row, 1) == ctas - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p = partials + row * ctas;
  float a = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < ctas; i += nt) a += __ldcg(p + i);
  const float t = block_sum(a, sh);
  if (threadIdx.x == 0) {
    out[row] = t;
    tickets[row] = 0;
  }
}

template <typename T, int VEC>
cudaError_t launch(int unroll, const void* g, long long b, long long n,
                   long long chunk, int ctas, int threads, float* partials,
                   int* tickets, float* out, cudaStream_t st) {
  if (unroll != kUnroll<VEC>) return cudaErrorInvalidValue;
  ef_sqnorm_kernel<T, VEC><<<(unsigned)(b * ctas), threads, 0, st>>>(
      static_cast<const T*>(g), n, chunk, ctas, partials, tickets, out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: the elements of a 16-byte load
// (8 bf16, 4 fp32) or 1 for the scalar route; threads, unroll, chunk
// (elements a CTA, whole steps of threads x unroll x vec) and ctas (chunks
// a row) come from kernels/ef_sqnorm.py:launch_plan. Where ctas > 1,
// ``partials`` holds b * ctas floats and ``tickets`` b zeroed ints, which
// the kernel leaves zeroed.
extern "C" int ef_sqnorm_launch(const void* g, int dtype, long long b,
                                long long n, int vec, int threads, int unroll,
                                long long chunk, int ctas, void* partials,
                                void* tickets, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > EF_MAX_THREADS || threads % 32 != 0 ||
      ctas < 1 || chunk < 1 || b * ctas > 0x7fffffffLL ||
      (ctas > 1 && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  int* tick = static_cast<int*>(tickets);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    if (vec == 8)
      return (int)launch<__nv_bfloat16, 8>(unroll, g, b, n, chunk, ctas, threads, part, tick, o, st);
    if (vec == 1)
      return (int)launch<__nv_bfloat16, 1>(unroll, g, b, n, chunk, ctas, threads, part, tick, o, st);
  } else if (dtype == 0) {
    if (vec == 4)
      return (int)launch<float, 4>(unroll, g, b, n, chunk, ctas, threads, part, tick, o, st);
    if (vec == 1)
      return (int)launch<float, 1>(unroll, g, b, n, chunk, ctas, threads, part, tick, o, st);
  }
  return (int)cudaErrorInvalidValue;
}
