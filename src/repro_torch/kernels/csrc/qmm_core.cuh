// The bodies shared by the qmm and grouped_qmm kernels (qmm.cu,
// grouped_qmm.cu). Both unpack a packed (K*, N) W{8,6,4,3} payload in the
// byte order of qtensor.unpack_rows into k-contiguous int8 words (4 k
// values of one column: what dp4a and mma.sync s8 take) with byte
// permutes, and sum exactly in int32, so the dots are equal whichever
// forms them:
//  - unit_words_scaled, qmm.cu's register-fed unpack: 6- and 4-bit values
//    are moved to the top of their byte (x4, x16) instead of being
//    sign-extended, which costs 1-2 logic ops a word, and the dot is
//    shifted back once (scale_shift);
//  - unit_words and tc_chunk_dots, grouped_qmm.cu's tensor-core dot: one
//    warp's exact int32 dots of up to 64 rows against 32 output columns
//    of a staged chunk of packed rows, with mma.sync.m16n8k32 s8.
#pragma once

#include "common.cuh"

namespace {

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

// log2 of the factor unit_words_scaled multiplies a value by
template <int BITS>
__host__ __device__ constexpr int scale_shift() { return BITS == 8 ? 0 : (BITS == 6 ? 2 : 4); }

// The words of one 4-k unit (its pack_rows<BITS>() packed rows, 4
// adjacent columns each) -> out[i] = the int8 values k = 4u..4u+3 of
// column i, times 2^scale_shift<BITS>(): a 6-bit value (x4) or a nibble
// (x16) lands in the top bits of its byte, whose sign bit is then the
// int8's, so no sign extension is needed. Every product, and so every
// partial dot, is a multiple of the factor: the dot shifts back exactly.
template <int BITS>
__device__ __forceinline__ void unit_words_scaled(const uint32_t (&r)[pack_rows<BITS>()],
                                                  uint32_t (&out)[4]) {
  if constexpr (BITS == 8) {
    transpose4(r[0], r[1], r[2], r[3], out);
  } else if constexpr (BITS == 6) {      // 4 values in 3 bytes along K
    const uint32_t x0 = (r[0] << 2) & 0xFCFCFCFCu;
    const uint32_t x1 = ((r[0] >> 4) & 0x0C0C0C0Cu) | ((r[1] << 4) & 0xF0F0F0F0u);
    const uint32_t x2 = ((r[1] >> 2) & 0x3C3C3C3Cu) | ((r[2] << 6) & 0xC0C0C0C0u);
    transpose4(x0, x1, x2, r[2] & 0xFCFCFCFCu, out);
  } else {                               // nibbles along K, low one first
    transpose4((r[0] << 4) & 0xF0F0F0F0u, r[0] & 0xF0F0F0F0u,
               (r[1] << 4) & 0xF0F0F0F0u, r[1] & 0xF0F0F0F0u, out);
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
