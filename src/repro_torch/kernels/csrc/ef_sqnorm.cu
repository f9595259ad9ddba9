// Per-row squared L2 norm of per-sample gradients, (B, N) -> (B,) fp32.
//
// Replaces the TPU kernel src/repro/kernels/ef_sqnorm.py:ef_sqnorm_pallas
// (_ef_kernel). Bound by bytes: every element is read once and costs two
// flops, far below the card's balance point. Design: pass 1 splits each
// row into fixed chunks, one block per (chunk, row), reading 16 bytes a
// thread where the row is aligned and reducing in fp32 with a fixed
// butterfly; pass 2 adds each row's chunk partials in a fixed order. No
// float atomics, so the result is the same bits on every run. Offsets
// are 64-bit: a row reaches 1.9e8 elements (the embed and head blocks).
#include "common.cuh"

namespace {

constexpr int EF_THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(EF_THREADS)
ef_partial_kernel(const T* __restrict__ g, long long n, long long chunk,
                  float* __restrict__ partials, long long nchunks) {
  __shared__ float sh[32];
  const long long row = blockIdx.y;
  const long long c = blockIdx.x;
  const long long lo = c * chunk;
  const long long hi = (lo + chunk < n) ? lo + chunk : n;
  const T* base = g + row * n;
  float acc = 0.f;
  if constexpr (VEC > 1) {
    // lo is a multiple of chunk (a multiple of VEC) and n % VEC == 0
    const uint4* vb = reinterpret_cast<const uint4*>(base + lo);
    const long long nv = (hi - lo) / VEC;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 u = __ldg(vb + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const float f = to_f(base[i]);
      acc = fmaf(f, f, acc);
    }
  }
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[row * nchunks + c] = s;
}

__global__ void __launch_bounds__(EF_THREADS)
ef_final_kernel(const float* __restrict__ partials, long long nchunks,
                float* __restrict__ out) {
  __shared__ float sh[32];
  const float* p = partials + (long long)blockIdx.x * nchunks;
  float acc = 0.f;
  for (long long i = threadIdx.x; i < nchunks; i += blockDim.x) acc += p[i];
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T, int VEC>
void launch_partial(const void* g, long long b, long long n, long long chunk,
                    float* partials, long long nchunks, cudaStream_t st) {
  dim3 grid((unsigned)nchunks, (unsigned)b);
  ef_partial_kernel<T, VEC><<<grid, EF_THREADS, 0, st>>>(
      static_cast<const T*>(g), n, chunk, partials, nchunks);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ``chunk`` must be a multiple of 8;
// ``partials`` holds b * ceil(n / chunk) floats.
extern "C" int ef_sqnorm_launch(const void* g, int dtype, long long b,
                                long long n, long long chunk, void* partials,
                                void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nchunks = (n + chunk - 1) / chunk;
  float* part = static_cast<float*>(partials);
  const bool aligned = (reinterpret_cast<uintptr_t>(g) % 16) == 0;
  if (dtype == 1) {
    if (aligned && n % 8 == 0)
      launch_partial<__nv_bfloat16, 8>(g, b, n, chunk, part, nchunks, st);
    else
      launch_partial<__nv_bfloat16, 1>(g, b, n, chunk, part, nchunks, st);
  } else {
    if (aligned && n % 4 == 0)
      launch_partial<float, 4>(g, b, n, chunk, part, nchunks, st);
    else
      launch_partial<float, 1>(g, b, n, chunk, part, nchunks, st);
  }
  ef_final_kernel<<<(unsigned)b, EF_THREADS, 0, st>>>(part, nchunks,
                                                     static_cast<float*>(out));
  return (int)cudaGetLastError();
}
