// Grouped-scale quantized matmul W{8,6,4,3}A8: (M, K) int8 activations
// with per-row fp32 scales x a packed (K*, N) QTensor payload with (G, N)
// fp32 group scales -> (M, N) fp32.
//
// Replaces the TPU kernel src/repro/kernels/qmm.py:qmm_pallas
// (_qmm_kernel). On the serving path it is a GEMV (M <= slots), bound by
// the packed weight bytes, which are read exactly once.
//
// Design, two launches:
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
#include "common.cuh"

namespace {

constexpr int QMM_MT = 4;          // activation rows per warp
constexpr int QMM_COLS = 128;      // output columns per warp (4 per lane)
constexpr int QMM_WARPS = 4;       // groups per block (one per warp)
constexpr int QMM_THREADS = QMM_WARPS * 32;
constexpr int QMM_BATCH = 32;      // packed rows loaded per batch

__device__ __forceinline__ int sext4(int v) { return v >= 8 ? v - 16 : v; }
__device__ __forceinline__ int sext6(int v) { return v >= 32 ? v - 64 : v; }

// Four adjacent bytes of one packed row starting at column c (c % 4 == 0).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int c, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + c));
  uint32_t u = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) u |= (uint32_t)row[c + j] << (8 * j);
  return u;
}

__device__ __forceinline__ int byte_at(uint32_t u, int j) { return (u >> (8 * j)) & 0xFF; }

// BITS: 8 (int8 payload; also the grid-reduced 7 and 5), 6 (4 values in
// 3 bytes along K), 4 (nibbles along K; also 3-bit values).
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
  const int k0 = g * gs;
  // the warp's activation slice, rows past M zero; 4-byte loads when the
  // group is a multiple of 4 (every QTensor group of the serving path)
  if (gs % 4 == 0 && k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) {
#pragma unroll
    for (int r = 0; r < QMM_MT; ++r)
      for (int o = lane * 4; o < gs; o += 128)
        *reinterpret_cast<uint32_t*>(xs + r * gs + o) =
            (r < mt) ? __ldg(reinterpret_cast<const uint32_t*>(
                           x + (long long)(m0 + r) * k + k0 + o))
                     : 0u;
  } else {
    for (int i = lane; i < QMM_MT * gs; i += 32) {
      const int r = i / gs, kk = i - r * gs;
      xs[i] = (r < mt) ? x[(long long)(m0 + r) * k + k0 + kk] : (int8_t)0;
    }
  }
  __syncwarp();

  const int c = blockIdx.x * QMM_COLS + lane * 4;
  if (c >= n) return;
  const long long ln = n;
  int dot[QMM_MT][4];
#pragma unroll
  for (int r = 0; r < QMM_MT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dot[r][j] = 0;

  // Rows are read QMM_BATCH at a time, all loads issued before any use,
  // so a warp keeps that many 128-byte reads in flight.
  if constexpr (BITS == 8 || BITS == 4) {
    constexpr int PER = (BITS == 8) ? 1 : 2;       // k values per byte
    const int rows = gs / PER;
    const uint8_t* wg = w + (long long)(k0 / PER) * ln;
    for (int base = 0; base < rows; base += QMM_BATCH) {
      uint32_t u[QMM_BATCH];
#pragma unroll
      for (int i = 0; i < QMM_BATCH; ++i)
        u[i] = (base + i < rows) ? load4(wg + (long long)(base + i) * ln, c, n, vec) : 0u;
#pragma unroll
      for (int i = 0; i < QMM_BATCH; ++i) {
        if (base + i >= rows) break;
        const int kk = PER * (base + i);
#pragma unroll
        for (int r = 0; r < QMM_MT; ++r) {
          const int x0 = xs[r * gs + kk];
          const int x1 = (PER == 2) ? xs[r * gs + kk + 1] : 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int b = byte_at(u[i], j);
            if constexpr (BITS == 8)
              dot[r][j] += (int)(int8_t)b * x0;
            else
              dot[r][j] += sext4(b & 0xF) * x0 + sext4((b >> 4) & 0xF) * x1;
          }
        }
      }
    }
  } else {  // BITS == 6: units of 3 packed rows hold 4 k values
    constexpr int UB = QMM_BATCH / 4;               // units per batch
    const int units = gs / 4;
    const uint8_t* wg = w + 3LL * (k0 / 4) * ln;
    for (int base = 0; base < units; base += UB) {
      uint32_t u[UB][3];
#pragma unroll
      for (int i = 0; i < UB; ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          u[i][q] = (base + i < units)
                        ? load4(wg + (3LL * (base + i) + q) * ln, c, n, vec) : 0u;
#pragma unroll
      for (int i = 0; i < UB; ++i) {
        if (base + i >= units) break;
        const int kk = 4 * (base + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b0 = byte_at(u[i][0], j), b1 = byte_at(u[i][1], j);
          const int b2 = byte_at(u[i][2], j);
          const int v0 = sext6(b0 & 0x3F);
          const int v1 = sext6(((b0 >> 6) & 0x3) | ((b1 & 0xF) << 2));
          const int v2 = sext6(((b1 >> 4) & 0xF) | ((b2 & 0x3) << 4));
          const int v3 = sext6((b2 >> 2) & 0x3F);
#pragma unroll
          for (int r = 0; r < QMM_MT; ++r) {
            const int8_t* xr = xs + r * gs + kk;
            dot[r][j] += v0 * xr[0] + v1 * xr[1] + v2 * xr[2] + v3 * xr[3];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < QMM_MT; ++r) {
    if (r >= mt) break;
    int* d = dots + ((long long)g * m + m0 + r) * ln + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < n) d[j] = dot[r][j];
  }
}

__global__ void qmm_fold_kernel(const int* __restrict__ dots,
                                const float* __restrict__ ws,
                                const float* __restrict__ xs,
                                float* __restrict__ out, int m, int n,
                                int groups) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * n) return;
  const int r = (int)(idx / n), c = (int)(idx - (long long)r * n);
  const long long plane = (long long)m * n;
  float acc = 0.f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g)
    acc = __fadd_rn(acc, __fmul_rn((float)dots[g * plane + idx],
                                   ws[(long long)g * n + c]));
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
