// W8A8 int8 matmul: (M, K) int8 activations with per-row fp32 scales x a
// (K, N) row-major int8 weight with per-column fp32 scales -> (M, N) fp32,
// out[m, n] = (f32(acc[m, n]) * x_scale[m]) * w_scale[n], with acc the
// full-K int32 dot.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py:
// int8_matmul_pallas (_int8_mm_kernel). On the serving path it is a GEMV
// (M <= the slot count; prefill replays one-token steps, M = 1), bound by
// the weight bytes, which are read exactly once.
//
// Design:
//  - A block owns 4 rows of M, 128 output columns and one split of K.
//    Its 8 warps walk that split 32 weight rows at a time (interleaved),
//    each lane loading one 32-bit word (4 adjacent columns) of every row,
//    all 32 loads issued before any is used: a warp keeps 4 KB in flight.
//  - The weight is (K, N) row-major, so a word holds 4 columns of one k.
//    Four rows' words are transposed with __byte_perm into 4 K-packed
//    words (one per column) and multiplied by the activation's K-packed
//    word with __dp4a: 16 dp4a per 4x4 byte tile instead of 64 scalar
//    multiply-adds. The activation words are loaded once per 32 rows,
//    one per lane, and broadcast with shuffles.
//  - The accumulation is int32 and cannot wrap (the wrapper proves
//    127 * 127 * K < 2^31), so K may be split across blocks and the
//    partial sums added in any order: the warps of a block add theirs in
//    shared memory, and when K is split the blocks add theirs into a
//    zeroed int32 scratch with atomics; a second launch then applies the
//    epilogue. When K is not split the block applies it itself. Either
//    way the result is exact and independent of M, the split and the
//    order: bit-identical to the plain version.
//  - Ragged M, K and N are masked in the kernel: no padded copy of the
//    weight is made (the TPU wrapper pads to block multiples).
#include "common.cuh"

namespace {

constexpr int I8_MT = 4;                 // activation rows per block
constexpr int I8_COLS = 128;             // output columns per block (4 per lane)
constexpr int I8_WARPS = 8;              // warps per block, each on its own K rows
constexpr int I8_THREADS = I8_WARPS * 32;
constexpr int I8_BATCH = 32;             // weight rows a warp loads before use

// Four adjacent int8 weights of row ``row`` at columns [c, c + 4).
__device__ __forceinline__ uint32_t load_w4(const int8_t* __restrict__ row,
                                            int c, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + c));
  uint32_t u = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) u |= (uint32_t)(uint8_t)row[c + j] << (8 * j);
  return u;
}

// Four consecutive activations x[r, k .. k + 4) (zero past K).
__device__ __forceinline__ uint32_t load_x4(const int8_t* __restrict__ xr,
                                            long long k, long long kend,
                                            bool vec) {
  if (vec && k + 3 < kend) return __ldg(reinterpret_cast<const uint32_t*>(xr + k));
  uint32_t u = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < kend) u |= (uint32_t)(uint8_t)xr[k + j] << (8 * j);
  return u;
}

// a[i] holds columns c..c+3 of row k+i; col[j] gets rows k..k+3 of
// column c+j, k-ascending from byte 0 (the byte order of load_x4).
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140);   // a0.0 a1.0 a0.1 a1.1
  const uint32_t t1 = __byte_perm(a0, a1, 0x7362);   // a0.2 a1.2 a0.3 a1.3
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140);
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, xs), ws);
}

// grid (ceil(N / 128), K splits, ceil(M / 4)); ``acc`` is null when K is
// not split (the block writes ``out`` itself), else a zeroed (M, N) int32
// scratch that receives the partial sums.
__global__ void __launch_bounds__(I8_THREADS)
int8_mm_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
               const int8_t* __restrict__ w, const float* __restrict__ ws,
               float* __restrict__ out, int* __restrict__ acc, int m,
               long long k, int n, long long chunk, bool wvec, bool xvec) {
  __shared__ int red[I8_MT * I8_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.z * I8_MT;
  const int mt = min(I8_MT, m - m0);
  const int c = blockIdx.x * I8_COLS + lane * 4;
  const bool col_ok = c < n;
  const long long kb0 = (long long)blockIdx.y * chunk;
  const long long kend = min(kb0 + chunk, k);

  for (int i = threadIdx.x; i < I8_MT * I8_COLS; i += I8_THREADS) red[i] = 0;

  int dot[I8_MT][4];
#pragma unroll
  for (int r = 0; r < I8_MT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dot[r][j] = 0;

  // lane l holds the activation word of row l / 8, k offset 4 * (l % 8)
  const int xr = lane >> 3, xq = (lane & 7) * 4;
  const int8_t* xrow = x + (long long)(m0 + min(xr, mt - 1)) * k;
  for (long long kb = kb0 + (long long)warp * I8_BATCH; kb < kend;
       kb += (long long)I8_WARPS * I8_BATCH) {
    uint32_t u[I8_BATCH];
#pragma unroll
    for (int i = 0; i < I8_BATCH; ++i)
      u[i] = (col_ok && kb + i < kend) ? load_w4(w + (kb + i) * n, c, n, wvec) : 0u;
    const uint32_t xw = (xr < mt) ? load_x4(xrow, kb + xq, kend, xvec) : 0u;
#pragma unroll
    for (int g = 0; g < I8_BATCH / 4; ++g) {
      uint32_t col[4];
      transpose4(u[4 * g], u[4 * g + 1], u[4 * g + 2], u[4 * g + 3], col);
#pragma unroll
      for (int r = 0; r < I8_MT; ++r) {
        const int xv = (int)__shfl_sync(0xffffffffu, xw, r * 8 + g);
        if (r < mt) {
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[r][j] = __dp4a((int)col[j], xv, dot[r][j]);
        }
      }
    }
  }

  __syncthreads();                        // red is zeroed
  if (col_ok) {
#pragma unroll
    for (int r = 0; r < I8_MT; ++r) {
      if (r >= mt) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&red[r * I8_COLS + lane * 4 + j], dot[r][j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < I8_MT * I8_COLS; i += I8_THREADS) {
    const int r = i / I8_COLS, cc = blockIdx.x * I8_COLS + (i - r * I8_COLS);
    if (r >= mt || cc >= n) continue;
    const long long o = (long long)(m0 + r) * n + cc;
    if (acc == nullptr)
      out[o] = epilogue(red[i], xs[m0 + r], ws[cc]);
    else
      atomicAdd(&acc[o], red[i]);
  }
}

__global__ void int8_mm_epilogue_kernel(const int* __restrict__ acc,
                                        const float* __restrict__ xs,
                                        const float* __restrict__ ws,
                                        float* __restrict__ out, int m, int n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * n) return;
  const int r = (int)(idx / n), c = (int)(idx - (long long)r * n);
  out[idx] = epilogue(acc[idx], xs[r], ws[c]);
}

}  // namespace

// x (M, K) int8, xs (M,) fp32, w (K, N) int8, ws (N,) fp32, out (M, N)
// fp32; ``acc``: null when ksplit == 1, else a zeroed (M, N) int32
// scratch. ``chunk``: K rows per split, a multiple of 32; ksplit =
// ceil(K / chunk). The wrapper (kernels/int8_matmul.py) picks both.
extern "C" int int8_matmul_launch(const void* x, const void* xs, const void* w,
                                  const void* ws, void* out, void* acc,
                                  long long m, long long k, long long n,
                                  long long chunk, long long ksplit,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wvec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const bool xvec = (k % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  dim3 grid((unsigned)((n + I8_COLS - 1) / I8_COLS), (unsigned)ksplit,
            (unsigned)((m + I8_MT - 1) / I8_MT));
  int8_mm_kernel<<<grid, I8_THREADS, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<float*>(out), ksplit > 1 ? static_cast<int*>(acc) : nullptr,
      (int)m, k, (int)n, chunk, wvec, xvec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit <= 1) return (int)e;
  const long long total = m * n;
  int8_mm_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(acc), static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<float*>(out), (int)m, (int)n);
  return (int)cudaGetLastError();
}
