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
//  - Per channel, x is seen as (outer, C, inner), so any channel axis
//    works without a transposing copy (the TPU wrapper takes the last
//    axis only). The grid is channel-stationary: a thread makes a
//    channel's grid (two loads and one IEEE division) once and applies it
//    to many elements. The wrapper's launch_plan (kernels/fake_quant.py)
//    picks one of three routes and the launch sizes:
//      rows  (the last axis, inner == 1): a thread owns a 16-byte column
//            vector (8 bf16/fp16 or 4 fp32 channels; one channel where a
//            row is not whole 16-byte vectors or a pointer is unaligned),
//            makes its grids once and walks rows gridDim.y·blockDim.y
//            apart, neighbouring threads on neighbouring 16 bytes of a
//            row, four rows' loads in flight before their stores;
//      runs  (inner of 32 or more vectors, e.g. axis 0 of a matrix): each
//            row of blockDim.x threads takes whole runs of one channel
//            (inner contiguous elements), the grid made once a run, four
//            loads in flight before their stores;
//      walk  (a short inner): the element-wise walk, the channel of
//            element i being (i / inner) % C, updated as a thread steps
//            through its vector.
//  - The arithmetic equals the plain version (kernels/ref.py:fake_quant)
//    bit for bit: the IEEE reciprocal (__fdiv_rn, never an approximate
//    one), multiply and add rounded separately (__fmul_rn/__fadd_rn: no
//    contraction into an FMA, which eager PyTorch does not do), rintf
//    (round half to even, as torch.round; roundf rounds half away from
//    zero), a clamp that keeps NaN, and round-to-nearest casts back.
//    The Pallas per-channel kernel divides by the scale instead; both
//    granularities here multiply by the reciprocal, as the oracle does.
#include <type_traits>

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

template <typename T, int V>
using VecOf = typename std::conditional<V == 1, T, uint4>::type;  // V elements

// One load's V elements through their grids: element j on g[j * GS]
// (GS = 1: a grid each; GS = 0: one grid for all).
template <typename T, int V, int GS>
__device__ __forceinline__ VecOf<T, V> fq_vec(VecOf<T, V> w, const Grid* g,
                                              float levels) {
  if constexpr (V == 1) {
    return from_f<T>(fq(g[0], to_f(w), levels));
  } else {
    Vec16<T> b;
    b.u = w;
#pragma unroll
    for (int j = 0; j < V; ++j) b.e[j] = from_f<T>(fq(g[j * GS], to_f(b.e[j]), levels));
    return b.u;
  }
}

// Route "rows": x is (rows, units·V) with V channels a unit; the thread
// (blockIdx.x·blockDim.x + threadIdx.x) owns unit u: channels uV..uV+V-1.
template <typename T, int V>
__global__ void __launch_bounds__(FQ_THREADS)
fq_rows_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows,
               int units, const float* __restrict__ scale,
               const float* __restrict__ zero_point, float levels) {
  using Vec = VecOf<T, V>;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  Grid g[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    g[j] = make_grid(__ldg(scale + u * V + j), __ldg(zero_point + u * V + j));
  const Vec* xv = reinterpret_cast<const Vec*>(x) + u;
  Vec* ov = reinterpret_cast<Vec*>(out) + u;
  const long long step = (long long)gridDim.y * blockDim.y;
  const long long stride = step * units;           // in units, between a thread's rows
  long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  xv += r * units;
  ov += r * units;
  auto apply = [&](Vec w) { return fq_vec<T, V, 1>(w, g, levels); };
  constexpr int R = 4;                             // rows in flight
  for (; r + (R - 1) * step < rows; r += R * step) {
    Vec w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = __ldcs(xv + i * stride);
#pragma unroll
    for (int i = 0; i < R; ++i) __stcs(ov + i * stride, apply(w[i]));
    xv += R * stride;
    ov += R * stride;
  }
  for (; r < rows; r += step, xv += stride, ov += stride) __stcs(ov, apply(__ldcs(xv)));
}

// Route "runs": x is (runs, units·V), run ru of channel ru % c; row
// threadIdx.y of the block takes runs blockIdx.x·blockDim.y + threadIdx.y,
// gridDim.x·blockDim.y apart, and its blockDim.x threads walk a run's
// units, each making the run's grid once.
template <typename T, int V>
__global__ void __launch_bounds__(FQ_THREADS)
fq_runs_kernel(const T* __restrict__ x, T* __restrict__ out, long long runs,
               long long units, int c, const float* __restrict__ scale,
               const float* __restrict__ zero_point, float levels) {
  using Vec = VecOf<T, V>;
  const long long step = (long long)gridDim.x * blockDim.y;
  long long ru = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (ru >= runs) return;
  int ch = (int)(ru % c);                          // one division a thread
  const int ch_step = (int)(step % c);
  const long long tstep = blockDim.x;
  for (; ru < runs; ru += step) {
    const Grid g = make_grid(__ldg(scale + ch), __ldg(zero_point + ch));
    const Vec* xv = reinterpret_cast<const Vec*>(x) + ru * units;
    Vec* ov = reinterpret_cast<Vec*>(out) + ru * units;
    auto apply = [&](Vec w) { return fq_vec<T, V, 0>(w, &g, levels); };
    constexpr int R = 4;                           // loads in flight
    long long i = threadIdx.x;
    for (; i + (R - 1) * tstep < units; i += R * tstep) {
      Vec w[R];
#pragma unroll
      for (int k = 0; k < R; ++k) w[k] = __ldcs(xv + i + k * tstep);
#pragma unroll
      for (int k = 0; k < R; ++k) __stcs(ov + i + k * tstep, apply(w[k]));
    }
    for (; i < units; i += tstep) __stcs(ov + i, apply(__ldcs(xv + i)));
    ch += ch_step;
    if (ch >= c) ch -= c;
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

// The launch plan's routes (kernels/fake_quant.py:launch_plan).
enum { FQ_WALK = 0, FQ_ROWS = 1, FQ_RUNS = 2 };

template <typename T>
void launch_walk(const T* x, T* out, long long n, long long c, long long inner,
                 const float* s, const float* z, float levels, int vec,
                 unsigned blocks, cudaStream_t st) {
  // 32-bit index arithmetic where every index (and the grid stride past
  // the last one) fits: the channel division runs once per vector
  if (n + (long long)blocks * FQ_THREADS * 16 < (1LL << 32))
    fq_channel_kernel<T, uint32_t><<<blocks, FQ_THREADS, 0, st>>>(
        x, out, (uint32_t)n, (uint32_t)c, (uint32_t)inner, s, z, levels, vec);
  else
    fq_channel_kernel<T, unsigned long long><<<blocks, FQ_THREADS, 0, st>>>(
        x, out, (unsigned long long)n, (unsigned long long)c,
        (unsigned long long)inner, s, z, levels, vec);
}

template <typename T>
void launch_channel(const void* x, void* out, long long n, long long c,
                    long long inner, const void* scale, const void* zp,
                    float levels, int route, int vec, int tx, int ty,
                    int blocks_x, int blocks_y, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  const dim3 block(tx, ty), grid(blocks_x, blocks_y);
  if (route == FQ_ROWS) {
    const long long rows = n / c;
    if (vec)
      fq_rows_kernel<T, V><<<grid, block, 0, st>>>(xt, ot, rows, (int)(c / V), s, z,
                                                   levels);
    else
      fq_rows_kernel<T, 1><<<grid, block, 0, st>>>(xt, ot, rows, (int)c, s, z, levels);
  } else if (route == FQ_RUNS) {
    const long long runs = n / inner;
    if (vec)
      fq_runs_kernel<T, V><<<grid, block, 0, st>>>(xt, ot, runs, inner / V, (int)c, s,
                                                   z, levels);
    else
      fq_runs_kernel<T, 1><<<grid, block, 0, st>>>(xt, ot, runs, inner, (int)c, s, z,
                                                   levels);
  } else {
    launch_walk<T>(xt, ot, n, c, inner, s, z, levels, vec, (unsigned)blocks_x, st);
  }
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
// route, vec and the launch sizes come from kernels/fake_quant.py:
// launch_plan (route 0 walk, 1 rows, 2 runs; vec: 16-byte vectors; a
// block of tx x ty threads, a grid of blocks_x x blocks_y).
extern "C" int fake_quant_per_channel_launch(const void* x, void* out,
                                             int dtype, long long n,
                                             long long c, long long inner,
                                             const void* scale,
                                             const void* zero_point,
                                             float levels, int route, int vec,
                                             int tx, int ty, int blocks_x,
                                             int blocks_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_channel<__nv_bfloat16>(x, out, n, c, inner, scale, zero_point, levels,
                                  route, vec, tx, ty, blocks_x, blocks_y, st);
  else if (dtype == 2)
    launch_channel<__half>(x, out, n, c, inner, scale, zero_point, levels, route,
                           vec, tx, ty, blocks_x, blocks_y, st);
  else
    launch_channel<float>(x, out, n, c, inner, scale, zero_point, levels, route,
                          vec, tx, ty, blocks_x, blocks_y, st);
  return (int)cudaGetLastError();
}
