// The bodies shared by the qmm and grouped_qmm kernels (qmm.cu,
// grouped_qmm.cu):
//  - group_dots, the scalar dot qmm.cu runs: one warp's exact int32 dots
//    of up to QMM_MT int8 activation rows against one scale group of a
//    packed (K*, N) W{8,6,4,3} payload, byte by byte;
//  - tc_chunk_dots, the tensor-core dot grouped_qmm.cu runs: one warp's
//    exact int32 dots of up to 64 rows against 32 output columns of a
//    staged chunk of packed rows, with mma.sync.m16n8k32 s8.
// Both unpack the payload in the byte order of qtensor.unpack_rows and
// sum exactly in int32, so the dots are equal whichever forms them.
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

// ---------------------------------------------------------------------------
// The tensor-core group dot. A CTA stages a chunk of up to TC_KC logical
// k values of one scale group: the packed rows of 128 output columns
// (128-byte rows) and the chunk of up to 64 activation rows
// (128-byte rows), each in shared memory with its 16-byte chunks
// XOR-swizzled so the reads below are free of bank conflicts. A warp
// owns 32 of the columns. mma.sync.m16n8k32 wants both operands
// k-contiguous in 32-bit words (4 k values of one row or column); the
// payload is n-contiguous. So a lane reads one 32-bit word (4 adjacent
// columns, one packed row) from each packed row of a 4-k unit, unpacks
// it to int8 and transposes the 4 x 4 bytes with byte permutes: one word
// of 4 k values for each of its 4 columns. Those 4 columns go to the 4
// n-tiles of the warp: n-tile i, n index gid <-> column 32·warp +
// 4·gid + i, so a lane's accumulators hold 8 adjacent output columns
// (32·warp + 8·(lane % 4) + 0..7). The A operand comes by ldmatrix.
// ---------------------------------------------------------------------------

constexpr int TC_COLS = 128;       // output columns per CTA tile (32 per warp)
constexpr int TC_KC = 128;         // logical k values per staged chunk
constexpr int TC_COL_WARPS = 4;    // warps, each with 32 of the 128 columns

// packed rows that hold 4 logical k values of one column
template <int BITS>
__host__ __device__ constexpr int pack_rows() { return BITS == 8 ? 4 : (BITS == 6 ? 3 : 2); }

// Byte offset of (packed row r of the chunk, byte b) in a staged weight
// slab: 16-byte chunks swizzled by the row's 4-k unit.
template <int BITS>
__device__ __forceinline__ int w_slab_off(int r, int b) {
  return r * 128 + ((((b >> 4) ^ (2 * ((r / pack_rows<BITS>()) & 3)))) << 4) + (b & 15);
}
// Byte offset of (activation row r, k byte b) in a staged activation slab.
__device__ __forceinline__ int x_slab_off(int r, int b) {
  return r * 128 + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// 4 bytes of signed nibbles / 6-bit values, sign-extended to int8 lanes
__device__ __forceinline__ uint32_t sext4_x4(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}
__device__ __forceinline__ uint32_t sext6_x4(uint32_t v) {
  return v | ((v & 0x20202020u) * 0x06u);
}

// out[i] = bytes i of w0, w1, w2, w3 (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3, uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// B words of 4-k unit u of the slab for the lane's 4 columns starting at
// byte b: out[i] = int8 values k = 4u..4u+3 of column b + i.
template <int BITS>
__device__ __forceinline__ void unit_words(const unsigned char* slab, int u, int b,
                                           uint32_t (&out)[4]) {
  constexpr int RPU = pack_rows<BITS>();
  uint32_t r[RPU];
#pragma unroll
  for (int j = 0; j < RPU; ++j)
    r[j] = *reinterpret_cast<const uint32_t*>(slab + w_slab_off<BITS>(RPU * u + j, b));
  if constexpr (BITS == 8) {
    transpose4(r[0], r[1], r[2], r[3], out);
  } else if constexpr (BITS == 6) {      // 4 values in 3 bytes along K
    const uint32_t x0 = r[0] & 0x3F3F3F3Fu;
    const uint32_t x1 = ((r[0] >> 6) & 0x03030303u) | ((r[1] & 0x0F0F0F0Fu) << 2);
    const uint32_t x2 = ((r[1] >> 4) & 0x0F0F0F0Fu) | ((r[2] & 0x03030303u) << 4);
    const uint32_t x3 = (r[2] >> 2) & 0x3F3F3F3Fu;
    transpose4(sext6_x4(x0), sext6_x4(x1), sext6_x4(x2), sext6_x4(x3), out);
  } else {                               // nibbles along K, low one first
    transpose4(sext4_x4(r[0] & 0x0F0F0F0Fu), sext4_x4((r[0] >> 4) & 0x0F0F0F0Fu),
               sext4_x4(r[1] & 0x0F0F0F0Fu), sext4_x4((r[1] >> 4) & 0x0F0F0F0Fu), out);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dot[mi][i] += the warp's m16n8 tiles of one staged chunk (its 4 k32
// steps; the chunk's k values past its length are zero in the activation
// slab), msub <= MS m16 subtiles of rows. wslab: the packed rows;
// xs_addr: the activation slab's shared address; warp: the 32-column
// slice.
template <int BITS, int MS>
__device__ __forceinline__ void tc_chunk_dots(const unsigned char* wslab,
                                              uint32_t xs_addr, int msub, int warp,
                                              int lane, int (&dot)[MS][4][4]) {
  const int gid = lane >> 2, c = lane & 3;
  const int b = 32 * warp + 4 * gid;
  const int arow = ((lane >> 3) & 1) * 8 + (lane & 7);   // ldmatrix row of this lane
#pragma unroll
  for (int ks = 0; ks < TC_KC / 32; ++ks) {
    uint32_t b0[4], b1[4];
    unit_words<BITS>(wslab, 8 * ks + c, b, b0);
    unit_words<BITS>(wslab, 8 * ks + 4 + c, b, b1);
#pragma unroll
    for (int mi = 0; mi < MS; ++mi) {
      if (mi >= msub) break;
      uint32_t a[4];
      const int r = mi * 16 + arow;
      ldsm_x4(a, xs_addr + x_slab_off(r, (2 * ks + (lane >> 4)) * 16));
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(dot[mi][i], a, b0[i], b1[i]);
    }
  }
}

}  // namespace
