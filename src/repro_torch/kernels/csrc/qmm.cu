// Grouped-scale quantized matmul W{8,6,4,3}A8: (M, K) int8 activations
// with per-row fp32 scales x a packed (K*, N) QTensor payload with (G, N)
// fp32 group scales -> (M, N) fp32.
//
// Replaces the TPU kernel src/repro/kernels/qmm.py:qmm_pallas
// (_qmm_kernel). On the serving path it is a GEMV (M <= slots), bound by
// the packed weight bytes, which are read exactly once.
//
// Design, two launches (bodies in qmm_core.cuh, shared with grouped_qmm.cu):
//  1. qmm_dots: one warp per (scale group, 128 output columns, 4 rows of
//     M). Each lane owns 4 adjacent columns and reads one 32-bit word of
//     every packed row of its group (a warp reads 128 contiguous bytes a
//     row), unpacks nibbles or 6-bit triples in registers in the byte
//     order of qtensor.unpack_rows, and forms the group's dot in exact
//     int32 against the activation rows held in shared memory. The grid
//     spans every (group, column tile), so small matrices still fill the
//     card. Dots go to a (G, M, N) int32 scratch buffer.
//  2. qmm_fold: one thread per output element folds
//     f32(dot[g]) * w_scale[g, n] over g = 0..G-1 in order and multiplies
//     by the row's activation scale once.
// The order of every sum is independent of M and of the tiling of M, so
// a row computed in a batch equals the same row computed alone, bit for
// bit. The TPU kernel's VMEM guard on the group size (4096) does not
// apply: the int32 bound is proven by the wrapper instead.
#include "qmm_core.cuh"

namespace {

template <int BITS>
__global__ void __launch_bounds__(QMM_THREADS)
qmm_dots_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                int* __restrict__ dots, int m, int k, int n, int groups,
                bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gs = k / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y * QMM_WARPS + warp;
  const int m0 = blockIdx.z * QMM_MT;
  const int mt = min(QMM_MT, m - m0);
  int8_t* xs = reinterpret_cast<int8_t*>(smem) + (size_t)warp * QMM_MT * gs;
  if (g >= groups) return;            // whole warp leaves; no block barrier below
  load_x_slice(x + (long long)m0 * k, mt, k, g * gs, gs, xs, lane);
  const int c = blockIdx.x * QMM_COLS + lane * 4;
  if (c >= n) return;
  int dot[QMM_MT][4];
  group_dots<BITS>(xs, w, n, g * gs, c, n, gs, vec, dot);
  store_dots(dots + ((long long)g * m + m0) * n, mt, n, c, n, dot);
}

__global__ void qmm_fold_kernel(const int* __restrict__ dots,
                                const float* __restrict__ ws,
                                const float* __restrict__ xs,
                                float* __restrict__ out, int m, int n,
                                int groups) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * n) return;
  const int r = (int)(idx / n), c = (int)(idx - (long long)r * n);
  const float acc = fold_groups(dots, (long long)m * n, idx, ws, n, c, groups);
  out[idx] = __fmul_rn(acc, xs[r]);
}

template <int BITS>
cudaError_t launch(const void* x, const void* xs, const void* w, const void* ws,
                   void* out, void* dots, int m, int k, int n, int groups,
                   cudaStream_t st) {
  const int gs = k / groups;
  const size_t smem = (size_t)QMM_WARPS * QMM_MT * gs;
  cudaError_t e = allow_smem(qmm_dots_kernel<BITS>, smem);
  if (e != cudaSuccess) return e;
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  dim3 grid((n + QMM_COLS - 1) / QMM_COLS, (groups + QMM_WARPS - 1) / QMM_WARPS,
            (m + QMM_MT - 1) / QMM_MT);
  qmm_dots_kernel<BITS><<<grid, QMM_THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<int*>(dots), m, k, n, groups, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = (long long)m * n;
  qmm_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(dots), static_cast<const float*>(ws),
      static_cast<const float*>(xs), static_cast<float*>(out), m, n, groups);
  return cudaGetLastError();
}

}  // namespace

// bits: the QTensor width (8/7/5 int8 payload, 6, 4/3 nibbles). ``dots``
// is a (G, M, N) int32 scratch buffer that receives the exact group dots
// (the on-card check compares them with the plain version).
extern "C" int qmm_launch(const void* x, const void* xs, const void* w,
                          const void* ws, void* out, void* dots, int bits,
                          long long m, long long k, long long n,
                          long long groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bits == 6)
    e = launch<6>(x, xs, w, ws, out, dots, (int)m, (int)k, (int)n, (int)groups, st);
  else if (bits == 4 || bits == 3)
    e = launch<4>(x, xs, w, ws, out, dots, (int)m, (int)k, (int)n, (int)groups, st);
  else
    e = launch<8>(x, xs, w, ws, out, dots, (int)m, (int)k, (int)n, (int)groups, st);
  return (int)e;
}
