// Grouped ragged quantized matmul for MoE serving, W{8,6,4,3}A8: every
// expert's projection in one pair of launches. (S, C, K) int8 segments
// with (S, C, 1) fp32 row scales x a packed (E, K*, N) expert stack with
// per-expert (E, G, N) fp32 group scales -> (S, C, N) fp32; segment s is
// fed by expert ids[s] and holds counts[s] valid rows; rows past the
// count are exactly 0.0.
//
// Replaces the TPU kernel src/repro/kernels/grouped_qmm.py:
// grouped_qmm_pallas (_grouped_qmm_kernel). At decode (C = 1, at most
// slots x top_k of the E experts with a row) it is bound by the packed
// bytes of the experts that have rows: each is read once, the others
// never.
//
// Design: qmm.cu with a segment dimension. The dot body is the device
// function of qmm_core.cuh and the fold has qmm.cu's arithmetic, so
// segment s's valid rows equal the qmm kernel on expert_slice(w, ids[s])
// bit for bit.
//  1. grouped_dots: grid (N / 128, G / 4, S x C / 4). Each block reads
//     counts[s] and ids[s] from device memory (the host never reads
//     them: no sync in the decode loop) and returns before touching a
//     weight byte when its 4-row tile starts at or past the count, so an
//     empty expert costs one tiny block per tile. Otherwise each warp
//     forms one (group, 128 columns) tile of exact int32 dots from
//     expert ids[s]'s payload into a (S, G, C, N) scratch buffer.
//  2. grouped_fold: one thread per output element folds the group terms
//     in order 0..G-1 with expert ids[s]'s scales, or writes 0.0 past
//     the count.
// Ids outside [0, E) make an empty segment (never an out-of-bounds read).
// At C = 1 each warp's tile of 4 rows holds one valid row: 3/4 of the
// dot registers idle (recorded in PERF.md; not addressed here).
#include "qmm_core.cuh"

namespace {

__device__ __forceinline__ int seg_count(const int* counts, int s, int cap) {
  return min(max(counts[s], 0), cap);
}

template <int BITS>
__global__ void __launch_bounds__(QMM_THREADS)
grouped_dots_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                    const int* __restrict__ counts, const int* __restrict__ ids,
                    int* __restrict__ dots, int cap, int k, int n, int groups,
                    int experts, long long expert_bytes, int mtiles, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.z / mtiles;
  const int m0 = (blockIdx.z - s * mtiles) * QMM_MT;
  const int count = seg_count(counts, s, cap);
  const int e = ids[s];
  if (m0 >= count || e < 0 || e >= experts) return;   // no weight byte read
  const int gs = k / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y * QMM_WARPS + warp;
  const int mt = min(QMM_MT, count - m0);
  int8_t* xs = reinterpret_cast<int8_t*>(smem) + (size_t)warp * QMM_MT * gs;
  if (g >= groups) return;            // whole warp leaves; no block barrier below
  load_x_slice(x + ((long long)s * cap + m0) * k, mt, k, g * gs, gs, xs, lane);
  const int c = blockIdx.x * QMM_COLS + lane * 4;
  if (c >= n) return;
  int dot[QMM_MT][4];
  group_dots<BITS>(xs, w + (long long)e * expert_bytes, n, g * gs, c, n, gs,
                   vec, dot);
  store_dots(dots + (((long long)s * groups + g) * cap + m0) * n, mt, n, c, n,
             dot);
}

__global__ void grouped_fold_kernel(const int* __restrict__ dots,
                                    const float* __restrict__ ws,
                                    const float* __restrict__ xs,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ ids,
                                    float* __restrict__ out, int segs, int cap,
                                    int n, int groups, int experts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)cap * n;
  if (idx >= segs * plane) return;
  const int s = (int)(idx / plane);
  const long long rem = idx - s * plane;
  const int r = (int)(rem / n), c = (int)(rem - (long long)r * n);
  const int e = ids[s];
  if (r >= seg_count(counts, s, cap) || e < 0 || e >= experts) {
    out[idx] = 0.f;
    return;
  }
  const float acc = fold_groups(dots + (long long)s * groups * plane, plane,
                                rem, ws + (long long)e * groups * n, n, c,
                                groups);
  out[idx] = __fmul_rn(acc, xs[(long long)s * cap + r]);
}

template <int BITS>
cudaError_t launch(const void* x, const void* xs, const void* w, const void* ws,
                   const void* counts, const void* ids, void* out, void* dots,
                   int segs, int cap, int k, int n, int groups, int experts,
                   long long expert_bytes, cudaStream_t st) {
  const int gs = k / groups;
  const size_t smem = (size_t)QMM_WARPS * QMM_MT * gs;
  cudaError_t e = allow_smem(grouped_dots_kernel<BITS>, smem);
  if (e != cudaSuccess) return e;
  const bool vec = (n % 4 == 0) && (expert_bytes % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const int mtiles = (cap + QMM_MT - 1) / QMM_MT;
  dim3 grid((n + QMM_COLS - 1) / QMM_COLS, (groups + QMM_WARPS - 1) / QMM_WARPS,
            segs * mtiles);
  grouped_dots_kernel<BITS><<<grid, QMM_THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const int*>(counts), static_cast<const int*>(ids),
      static_cast<int*>(dots), cap, k, n, groups, experts, expert_bytes,
      mtiles, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = (long long)segs * cap * n;
  grouped_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(dots), static_cast<const float*>(ws),
      static_cast<const float*>(xs), static_cast<const int*>(counts),
      static_cast<const int*>(ids), static_cast<float*>(out), segs, cap, n,
      groups, experts);
  return cudaGetLastError();
}

}  // namespace

// bits: the QTensor width (8/7/5 int8 payload, 6, 4/3 nibbles);
// expert_bytes: packed payload bytes of one expert (K* x N). ``dots`` is
// a (S, G, C, N) int32 scratch buffer; only rows below each segment's
// count are written (the on-card check compares those with the plain
// version).
extern "C" int grouped_qmm_launch(const void* x, const void* xs, const void* w,
                                  const void* ws, const void* counts,
                                  const void* ids, void* out, void* dots,
                                  int bits, long long segs, long long cap,
                                  long long k, long long n, long long groups,
                                  long long experts, long long expert_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int a = (int)segs, c = (int)cap, kk = (int)k, nn = (int)n;
  const int g = (int)groups, ex = (int)experts;
  cudaError_t e;
  if (bits == 6)
    e = launch<6>(x, xs, w, ws, counts, ids, out, dots, a, c, kk, nn, g, ex,
                  expert_bytes, st);
  else if (bits == 4 || bits == 3)
    e = launch<4>(x, xs, w, ws, counts, ids, out, dots, a, c, kk, nn, g, ex,
                  expert_bytes, st);
  else
    e = launch<8>(x, xs, w, ws, counts, ids, out, dots, a, c, kk, nn, g, ex,
                  expert_bytes, st);
  return (int)e;
}
