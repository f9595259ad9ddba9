// The body shared by the qmm and grouped_qmm kernels (qmm.cu,
// grouped_qmm.cu): one warp's exact int32 dots of up to QMM_MT int8
// activation rows against one scale group of a packed (K*, N) W{8,6,4,3}
// payload, and the in-order fold of the scaled group terms. Both kernels
// run exactly this code on a row, so a grouped segment's rows equal the
// qmm kernel's on the same expert, bit for bit.
#pragma once

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

// The warp's activation slice: columns [k0, k0 + gs) of rows [0, mt) of
// x (row stride k) into xs (QMM_MT x gs), rows past mt zero; 4-byte loads
// when the group is a multiple of 4 (every QTensor group of the serving
// path).
__device__ __forceinline__ void load_x_slice(const int8_t* __restrict__ x,
                                             int mt, int k, int k0, int gs,
                                             int8_t* xs, int lane) {
  if (gs % 4 == 0 && k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) {
#pragma unroll
    for (int r = 0; r < QMM_MT; ++r)
      for (int o = lane * 4; o < gs; o += 128)
        *reinterpret_cast<uint32_t*>(xs + r * gs + o) =
            (r < mt) ? __ldg(reinterpret_cast<const uint32_t*>(
                           x + (long long)r * k + k0 + o))
                     : 0u;
  } else {
    for (int i = lane; i < QMM_MT * gs; i += 32) {
      const int r = i / gs, kk = i - r * gs;
      xs[i] = (r < mt) ? x[(long long)r * k + k0 + kk] : (int8_t)0;
    }
  }
  __syncwarp();
}

// Exact int32 dots of the QMM_MT rows in xs against columns [c, c + 4)
// of the scale group starting at logical row k0 of the packed payload w
// (N = ln columns). BITS: 8 (int8 payload; also the grid-reduced 7 and
// 5), 6 (4 values in 3 bytes along K), 4 (nibbles along K; also 3-bit).
// Rows are read QMM_BATCH at a time, all loads started before any use, so
// a warp keeps that many 128-byte reads in flight.
template <int BITS>
__device__ __forceinline__ void group_dots(const int8_t* xs,
                                           const uint8_t* __restrict__ w,
                                           long long ln, int k0, int c, int n,
                                           int gs, bool vec,
                                           int (&dot)[QMM_MT][4]) {
#pragma unroll
  for (int r = 0; r < QMM_MT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dot[r][j] = 0;

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
}

// Store the first mt rows of the dots; d points at (group, first row,
// column 0) of a (G, M, N) plane stack.
__device__ __forceinline__ void store_dots(int* __restrict__ d, int mt,
                                           long long ln, int c, int n,
                                           int (&dot)[QMM_MT][4]) {
#pragma unroll
  for (int r = 0; r < QMM_MT; ++r) {
    if (r >= mt) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < n) d[r * ln + c + j] = dot[r][j];
  }
}

// f32(dot[g]) * w_scale[g, c] folded over g = 0..G-1 in order, from the
// (G, M, N) dots (plane = M * N elements apart) of output element idx.
__device__ __forceinline__ float fold_groups(const int* __restrict__ dots,
                                             long long plane, long long idx,
                                             const float* __restrict__ ws,
                                             long long ln, int c, int groups) {
  float acc = 0.f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g)
    acc = __fadd_rn(acc, __fmul_rn((float)dots[g * plane + idx],
                                   ws[(long long)g * ln + c]));
  return acc;
}

}  // namespace
