// Grouped-scale quantized matmul W{8,6,4,3}A8 and its two halves: the
// per-group scaled partial products and their in-order fold.
//
// Replaces the TPU kernels src/repro/kernels/qmm.py:qmm_pallas
// (_qmm_kernel: (M, K) int8 activations with per-row fp32 scales x a packed
// (K*, N) QTensor payload with (G, N) fp32 group scales -> (M, N) fp32) and
// qmm_groups_pallas (_qmm_groups_kernel: the same product as (G, M, N)
// fp32 terms out[g] = f32(exact int32 dot of group g) * w_scale[g], no
// group sum: the shard-local half of a K-sharded, row-parallel, qmm in
// tensor-parallel serving). On the serving path both are GEMVs (M <= the
// slot count), bound by the packed weight bytes, which are read once.
//
// Design, two launches (the dot body in qmm_core.cuh, shared with
// grouped_qmm.cu):
//  1. qmm_groups: one warp per (scale group, 128 output columns, 4 rows of
//     M), looping over the rows of M so a prefill of any length runs in
//     one launch. Each lane owns 4 adjacent columns and reads one 32-bit
//     word of every packed row of its group (a warp reads 128 contiguous
//     bytes a row), unpacks nibbles or 6-bit triples in registers in the
//     byte order of qtensor.unpack_rows, and forms the group's dot in exact
//     int32 against the activation rows held in shared memory. The grid
//     spans every (group, column tile), so small matrices still fill the
//     card. It stores __fmul_rn((float)dot, ws[g, c]) into (G, M, N) fp32.
//  2. qmm_groups_fold: one thread per output element folds
//     acc = __fadd_rn(acc, t[g]) over g = 0..G-1 in order and multiplies by
//     the row's activation scale once (__fmul_rn).
// qmm is launch 1 then launch 2 on the whole K. The order of every sum is
// independent of M and of the tiling of M, so a row computed in a batch
// equals the same row computed alone, bit for bit; and terms gathered from
// K-shards that own whole groups fold to qmm's output on the whole K, bit
// for bit. The TPU kernel's VMEM guard on the group size (4096) does not
// apply: the int32 bound is proven by the wrapper instead.
#include "qmm_core.cuh"

namespace {

constexpr int MAX_GRID_Z = 65535;

template <int BITS>
__global__ void __launch_bounds__(QMM_THREADS)
qmm_groups_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ ws, float* __restrict__ out,
                  int m, int k, int n, int groups, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gs = k / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y * QMM_WARPS + warp;
  int8_t* xs = reinterpret_cast<int8_t*>(smem) + (size_t)warp * QMM_MT * gs;
  if (g >= groups) return;            // whole warp leaves; no block barrier below
  const int c = blockIdx.x * QMM_COLS + lane * 4;
  for (int m0 = blockIdx.z * QMM_MT; m0 < m; m0 += gridDim.z * QMM_MT) {
    const int mt = min(QMM_MT, m - m0);
    load_x_slice(x + (long long)m0 * k, mt, k, g * gs, gs, xs, lane);
    if (c < n) {
      int dot[QMM_MT][4];
      group_dots<BITS>(xs, w, n, g * gs, c, n, gs, vec, dot);
      float* o = out + ((long long)g * m + m0) * n;
      const float* wsg = ws + (long long)g * n;
#pragma unroll
      for (int r = 0; r < QMM_MT; ++r) {
        if (r >= mt) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n)
            o[(long long)r * n + c + j] = __fmul_rn((float)dot[r][j], wsg[c + j]);
      }
    }
    __syncwarp();                     // every lane done with xs before the next load
  }
}

__global__ void qmm_groups_fold_kernel(const float* __restrict__ terms,
                                       const float* __restrict__ xs,
                                       float* __restrict__ out, int m, int n,
                                       int groups) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)m * n;
  if (idx >= plane) return;
  const int r = (int)(idx / n);
  float acc = 0.f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) acc = __fadd_rn(acc, terms[g * plane + idx]);
  out[idx] = __fmul_rn(acc, xs[r]);
}

template <int BITS>
cudaError_t launch_groups(const void* x, const void* w, const void* ws,
                          void* out, int m, int k, int n, int groups,
                          cudaStream_t st) {
  const int gs = k / groups;
  const size_t smem = (size_t)QMM_WARPS * QMM_MT * gs;
  cudaError_t e = allow_smem(qmm_groups_kernel<BITS>, smem);
  if (e != cudaSuccess) return e;
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const int mtiles = (m + QMM_MT - 1) / QMM_MT;
  dim3 grid((n + QMM_COLS - 1) / QMM_COLS, (groups + QMM_WARPS - 1) / QMM_WARPS,
            mtiles < MAX_GRID_Z ? mtiles : MAX_GRID_Z);
  qmm_groups_kernel<BITS><<<grid, QMM_THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(ws), static_cast<float*>(out), m, k, n, groups,
      vec);
  return cudaGetLastError();
}

// bits: the QTensor width (8/7/5 int8 payload, 6, 4/3 nibbles)
cudaError_t groups_by_bits(const void* x, const void* w, const void* ws,
                           void* out, int bits, int m, int k, int n, int groups,
                           cudaStream_t st) {
  if (bits == 6) return launch_groups<6>(x, w, ws, out, m, k, n, groups, st);
  if (bits == 4 || bits == 3)
    return launch_groups<4>(x, w, ws, out, m, k, n, groups, st);
  return launch_groups<8>(x, w, ws, out, m, k, n, groups, st);
}

cudaError_t launch_fold(const void* terms, const void* xs, void* out, int m,
                        int n, int groups, cudaStream_t st) {
  const long long total = (long long)m * n;
  qmm_groups_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(terms), static_cast<const float*>(xs),
      static_cast<float*>(out), m, n, groups);
  return cudaGetLastError();
}

}  // namespace

// (M, K) int8, (M,) fp32 row scales, packed (K*, N), (G, N) fp32 -> (M, N)
// fp32 in ``out``; ``terms`` is a (G, M, N) fp32 scratch buffer that
// receives the group terms (the on-card check compares them with the plain
// version).
extern "C" int qmm_launch(const void* x, const void* xs, const void* w,
                          const void* ws, void* out, void* terms, int bits,
                          long long m, long long k, long long n,
                          long long groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = groups_by_bits(x, w, ws, terms, bits, (int)m, (int)k, (int)n,
                                 (int)groups, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_fold(terms, xs, out, (int)m, (int)n, (int)groups, st);
}

// (M, K) int8, packed (K*, N), (G, N) fp32 -> the (G, M, N) fp32 terms.
extern "C" int qmm_groups_launch(const void* x, const void* w, const void* ws,
                                 void* out, int bits, long long m, long long k,
                                 long long n, long long groups, void* stream) {
  return (int)groups_by_bits(x, w, ws, out, bits, (int)m, (int)k, (int)n,
                             (int)groups, static_cast<cudaStream_t>(stream));
}

// (G, M, N) fp32 terms, (M,) fp32 row scales -> (M, N) fp32.
extern "C" int qmm_groups_fold_launch(const void* terms, const void* xs,
                                      void* out, long long m, long long n,
                                      long long groups, void* stream) {
  return (int)launch_fold(terms, xs, out, (int)m, (int)n, (int)groups,
                          static_cast<cudaStream_t>(stream));
}
