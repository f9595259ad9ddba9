// Fake quantization (quantize, then dequantize) on a uniform grid, per
// tensor or per channel along any axis:
//   q   = clamp(rint(x * (1/s) + zp), 0, levels)
//   out = (q - zp) * s, cast back to x's dtype (fp32, bf16 or fp16).
//
// Replaces the TPU kernels src/repro/kernels/fake_quant.py:
// fake_quant_pallas (_fq_kernel) and fake_quant_per_channel_pallas
// (_fq_pc_kernel). Elementwise, bound by bytes: x is read once and the
// output written once (a W4 pass over a 2048x8192 bf16 block moves 67 MB,
// ~20 us at 3.35 TB/s).
//
// Design:
//  - A grid-stride loop over 16-byte vectors (8 bf16/fp16 or 4 fp32 a
//    thread), loads and stores of 16 bytes, and a scalar tail; the
//    scalar loop alone when x or out is not 16-byte aligned.
//  - Scale and zero point are read from device memory (they come from
//    quant_params or a calibration observer on the card), so the caller
//    never syncs to pass them; ``levels`` is a plain float argument.
//  - Per channel, x is seen as (outer, C, inner): the channel of element
//    i is (i / inner) % C, so any channel axis works without a
//    transposing copy. The TPU wrapper takes the last axis only.
//  - The arithmetic equals the plain version (kernels/ref.py:fake_quant)
//    bit for bit: the IEEE reciprocal (__fdiv_rn, never an approximate
//    one), multiply and add rounded separately (__fmul_rn/__fadd_rn: no
//    contraction into an FMA, which eager PyTorch does not do), rintf
//    (round half to even, as torch.round; roundf rounds half away from
//    zero), a clamp that keeps NaN, and round-to-nearest casts back.
//    The Pallas per-channel kernel divides by the scale instead; both
//    granularities here multiply by the reciprocal, as the oracle does.
#include "common.cuh"

namespace {

constexpr int FQ_THREADS = 256;
constexpr unsigned FQ_MAX_BLOCKS = 4096;

// One grid: scale, its IEEE reciprocal, zero point.
struct Grid {
  float s, inv, zp;
};

__device__ __forceinline__ Grid make_grid(float s, float zp) {
  return Grid{s, __fdiv_rn(1.0f, s), zp};
}

__device__ __forceinline__ float fq(const Grid& g, float x, float levels) {
  float q = rintf(__fadd_rn(__fmul_rn(x, g.inv), g.zp));
  q = q < 0.f ? 0.f : (q > levels ? levels : q);
  return __fmul_rn(__fsub_rn(q, g.zp), g.s);
}

template <typename T>
union Vec16 {
  uint4 u;
  T e[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(FQ_THREADS)
fq_tensor_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                 const float* __restrict__ scale,
                 const float* __restrict__ zero_point, float levels,
                 int vec) {
  constexpr int V = 16 / sizeof(T);
  const Grid g = make_grid(*scale, *zero_point);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long nv = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      Vec16<T> b;
      b.u = __ldcs(xv + i);
#pragma unroll
      for (int j = 0; j < V; ++j) b.e[j] = from_f<T>(fq(g, to_f(b.e[j]), levels));
      __stcs(ov + i, b.u);
    }
    head = nv * V;
  }
  for (long long i = head + tid; i < n; i += stride)
    out[i] = from_f<T>(fq(g, to_f(x[i]), levels));
}

// Channel tracking of one element: index i of x seen as (outer, C, inner).
template <typename I>
struct Chan {
  I r, ch;
  __device__ __forceinline__ Chan(I i, I c, I inner) {
    const I q = i / inner;
    r = i - q * inner;
    ch = q % c;
  }
  // step to element i + 1; true when the channel changed
  __device__ __forceinline__ bool next(I c, I inner) {
    if (++r < inner) return false;
    r = 0;
    ch = (ch + 1 == c) ? 0 : ch + 1;
    return true;
  }
};

template <typename T, typename I>
__global__ void __launch_bounds__(FQ_THREADS)
fq_channel_kernel(const T* __restrict__ x, T* __restrict__ out, I n, I c,
                  I inner, const float* __restrict__ scale,
                  const float* __restrict__ zero_point, float levels,
                  int vec) {
  constexpr int V = 16 / sizeof(T);
  const I tid = (I)blockIdx.x * blockDim.x + threadIdx.x;
  const I stride = (I)gridDim.x * blockDim.x;
  I head = 0;
  if (vec) {
    const I nv = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (I i = tid; i < nv; i += stride) {
      Vec16<T> b;
      b.u = __ldcs(xv + i);
      Chan<I> at(i * V, c, inner);
      Grid g = make_grid(__ldg(scale + at.ch), __ldg(zero_point + at.ch));
#pragma unroll
      for (int j = 0; j < V; ++j) {
        b.e[j] = from_f<T>(fq(g, to_f(b.e[j]), levels));
        if (j + 1 < V && at.next(c, inner))
          g = make_grid(__ldg(scale + at.ch), __ldg(zero_point + at.ch));
      }
      __stcs(ov + i, b.u);
    }
    head = nv * V;
  }
  for (I i = head + tid; i < n; i += stride) {
    const Chan<I> at(i, c, inner);
    const Grid g = make_grid(__ldg(scale + at.ch), __ldg(zero_point + at.ch));
    out[i] = from_f<T>(fq(g, to_f(x[i]), levels));
  }
}

unsigned blocks_for(long long work) {
  const long long b = (work + FQ_THREADS - 1) / FQ_THREADS;
  return (unsigned)(b < 1 ? 1 : (b > FQ_MAX_BLOCKS ? FQ_MAX_BLOCKS : b));
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(b) % 16) == 0;
}

template <typename T>
void launch_tensor(const void* x, void* out, long long n, const void* scale,
                   const void* zp, float levels, cudaStream_t st) {
  const int vec = aligned16(x, out);
  const long long work = vec ? n / (16 / sizeof(T)) + 16 : n;
  fq_tensor_kernel<T><<<blocks_for(work), FQ_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n,
      static_cast<const float*>(scale), static_cast<const float*>(zp), levels,
      vec);
}

template <typename T>
void launch_channel(const void* x, void* out, long long n, long long c,
                    long long inner, const void* scale, const void* zp,
                    float levels, cudaStream_t st) {
  const int vec = aligned16(x, out);
  const long long work = vec ? n / (16 / sizeof(T)) + 16 : n;
  const unsigned blocks = blocks_for(work);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  // 32-bit index arithmetic where every index (and the grid stride past
  // the last one) fits: the channel division runs once per vector
  if (n + (long long)blocks * FQ_THREADS * 16 < (1LL << 32))
    fq_channel_kernel<T, uint32_t><<<blocks, FQ_THREADS, 0, st>>>(
        xt, ot, (uint32_t)n, (uint32_t)c, (uint32_t)inner, s, z, levels, vec);
  else
    fq_channel_kernel<T, unsigned long long><<<blocks, FQ_THREADS, 0, st>>>(
        xt, ot, (unsigned long long)n, (unsigned long long)c,
        (unsigned long long)inner, s, z, levels, vec);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16. scale / zero_point: one fp32 each.
extern "C" int fake_quant_launch(const void* x, void* out, int dtype,
                                 long long n, const void* scale,
                                 const void* zero_point, float levels,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_tensor<__nv_bfloat16>(x, out, n, scale, zero_point, levels, st);
  else if (dtype == 2)
    launch_tensor<__half>(x, out, n, scale, zero_point, levels, st);
  else
    launch_tensor<float>(x, out, n, scale, zero_point, levels, st);
  return (int)cudaGetLastError();
}

// x seen as (n / (c * inner), c, inner); scale / zero_point: c fp32 each.
extern "C" int fake_quant_per_channel_launch(const void* x, void* out,
                                             int dtype, long long n,
                                             long long c, long long inner,
                                             const void* scale,
                                             const void* zero_point,
                                             float levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_channel<__nv_bfloat16>(x, out, n, c, inner, scale, zero_point,
                                  levels, st);
  else if (dtype == 2)
    launch_channel<__half>(x, out, n, c, inner, scale, zero_point, levels, st);
  else
    launch_channel<float>(x, out, n, c, inner, scale, zero_point, levels, st);
  return (int)cudaGetLastError();
}
