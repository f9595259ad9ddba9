// The bodies shared by the qmm, int8_matmul and grouped_qmm kernels
// (qmm.cu, int8_matmul.cu, grouped_qmm.cu); qmm_body, the GEMV of qmm
// and int8_matmul, and its two kernels are at the end. qmm and grouped_qmm unpack a packed
// (K*, N) W{8,6,4,3} payload in the byte order of qtensor.unpack_rows
// into k-contiguous int8 words (4 k values of one column: what dp4a and
// mma.sync s8 take) with byte permutes, and sum exactly in int32, so the
// dots are equal whichever forms them:
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

// ---------------------------------------------------------------------------
// The register-fed GEMV of qmm.cu (qmm_kernel: qmm and qmm_groups) and
// int8_matmul.cu (int8_mm_kernel: BITS = 8, one group over all of K, I8
// = true). Its design is described at the top of qmm.cu. The two kernels
// are separate entries so each keeps its own __launch_bounds__: a
// min-blocks bound on qmm's 16-column lanes would raise their registers
// and cost its head a CTA an SM.
// ---------------------------------------------------------------------------

constexpr int QK_MAX_THREADS = 512;
constexpr int MAX_GRID_Y = 65535;
// k32 steps a warp loads together; two such batches are in flight
constexpr int QK_BATCH = 2;
// activation rows of a CTA tile: the mma's B operand (M padded to 8)
constexpr int QK_MT = 8;

// shared memory of a CTA: per group of a pass, its int32 dots (rows x
// cols) and scales (cols); the running fold (8 x cols); the row scales
size_t qmm_smem(int pass_groups, int rows, int cols) {
  return (size_t)pass_groups * (rows * cols * 4 + cols * 4) + (size_t)8 * cols * 4 + 8 * 4;
}

// QW adjacent 32-bit words of one packed row from column c
template <int QW>
__device__ __forceinline__ void load_quads(const uint8_t* __restrict__ p, uint32_t (&v)[QW]) {
  if constexpr (QW == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// The int8 activation values k = 4u..4u+3 of one row as a word, zero
// outside the group's [k0, k1)
__device__ __forceinline__ uint32_t x_word(const int8_t* __restrict__ xr, int u,
                                           int k0, int k1) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * u + b >= k0 && 4 * u + b < k1) v |= (uint32_t)(uint8_t)xr[4 * u + b] << (8 * b);
  return v;
}

// I8: int8_matmul's epilogue, __fmul_rn(__fmul_rn(f32(dot), xs), ws),
// in place of the group fold (one group spanning K, no terms), with the
// scales read xs_step and ws_step values apart (0: one value).
template <int BITS, int QW, bool I8>
__device__ __forceinline__ void qmm_body(
    const int8_t* __restrict__ x, const float* __restrict__ xs, const uint8_t* __restrict__ w,
    const float* __restrict__ ws, float* __restrict__ out, float* __restrict__ terms, int m,
    int k, int n, int groups, long long kp, int spg, int pass_groups, int rows, bool vecq,
    bool vec4, bool xvec, int xs_step, int ws_step) {
  constexpr int MT = QK_MT;
  constexpr int COLS = 32 * QW;                    // 8 lane groups x QW column quads
  constexpr int PR = pack_rows<BITS>();
  constexpr int NB = QW == 4 ? 1 : QK_BATCH;      // 16-column lanes: a step a batch
  constexpr int AR = 2 * QW;                      // accumulator fragments
  constexpr int SHIFT = scale_shift<BITS>();
  using WRegs = uint32_t[NB][2][PR][QW];
  using XRegs = uint32_t[NB][2];
  extern __shared__ __align__(16) unsigned char smem[];
  int* sdot = reinterpret_cast<int*>(smem);                          // [pass][rows][COLS]
  float* sws = reinterpret_cast<float*>(sdot + pass_groups * rows * COLS);  // [pass][COLS]
  float* sacc = sws + pass_groups * COLS;                            // [MT][COLS]
  float* sxs = sacc + MT * COLS;                                     // [MT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gid = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * COLS, col = n0 + 4 * QW * gid;
  const int gs = k / groups;
  // A lane takes 4-k units 2c and 2c + 1 of each step (h = 0, 1): its
  // activation words are then 8 adjacent bytes. The fast path: every
  // group a whole number of k32 steps, payload rows aligned for the
  // lane's QW words, x 16-byte-aligned. Item i of a pass is then the
  // global k32 chunk gp0·spg + i, read from per-lane bases at fixed
  // offsets.
  const bool fast = vecq && xvec && gs % 32 == 0;
  const int xrow = gid;                                     // the lane's B row
  const uint8_t* wl = w + 2LL * PR * c * n + col;           // unit 2c, packed row 0
  const long long wstep = 8LL * PR * n;                     // payload bytes a k32 step
  const int xss = I8 ? xs_step : 1, wss = I8 ? ws_step : 1;

  for (int m0 = blockIdx.y * MT; m0 < m; m0 += gridDim.y * MT) {
    const int mt = min(MT, m - m0);
    const int8_t* xl = x + (long long)(m0 + xrow) * k + 8 * c;
    for (int gp0 = 0; gp0 < groups; gp0 += pass_groups) {
      const int gcount = min(pass_groups, groups - gp0);
      for (int i = threadIdx.x; i < gcount * COLS; i += blockDim.x) {
        const int cc = i % COLS;
        if (n0 + cc < n)
          cp_async4(sws + i, ws + ((long long)(gp0 + i / COLS) * n + n0 + cc) * wss);
      }
      if (out != nullptr && gp0 + gcount >= groups && threadIdx.x < mt)
        cp_async4(sxs + threadIdx.x, xs + (long long)(m0 + threadIdx.x) * xss);
      asm volatile("cp.async.commit_group;\n" ::);
      for (int i = threadIdx.x; i < gcount * rows * COLS; i += blockDim.x) sdot[i] = 0;

      // this warp's (group, step) items: item i is step i % spg of group
      // gp0 + i / spg
      const int items = gcount * spg;
      const int ipw = (items + nwarps - 1) / nwarps;
      const int it0 = min(items, warp * ipw), it1 = min(items, it0 + ipw);
      int acc[AR][4];
      int cur = -1, g = gp0 + it0 / spg, sg = it0 % spg;   // sg: steps of g begun
      if constexpr (I8) {                // one group: no group changes to track
#pragma unroll
        for (int a = 0; a < AR; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = 0;
        cur = it0 < it1 ? gp0 : -1;
      }

      // item i's words: 2 units x PR packed rows x QW quads, 2 units of
      // the lane's activation row
      auto load = [&](int i, uint32_t (&wr)[2][PR][QW], uint32_t (&xr)[2]) {
        if (fast) {
          const long long chunk = (long long)gp0 * spg + i;
          const uint8_t* wp = wl + chunk * wstep;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < PR; ++j) {
              if (col < n) {
                load_quads<QW>(wp + (long long)(PR * h + j) * n, wr[h][j]);
              } else {
#pragma unroll
                for (int q = 0; q < QW; ++q) wr[h][j][q] = 0u;
              }
            }
          const uint2 v = xrow < mt ? __ldg(reinterpret_cast<const uint2*>(xl + 32 * chunk))
                                    : make_uint2(0u, 0u);
          xr[0] = v.x;
          xr[1] = v.y;
          return;
        }
        // item i: step si of group gi (one group spanning K with I8)
        const int gi = I8 ? 0 : i / spg, si = I8 ? i : i % spg;
        const int k0 = (gp0 + gi) * gs, k1 = k0 + gs;
        const int ub = (k1 + 3) >> 2;             // past the group's last unit
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = (k0 >> 2) + 8 * si + 2 * c + h;
#pragma unroll
          for (int j = 0; j < PR; ++j) {
            const long long row = (long long)PR * u + j;
#pragma unroll
            for (int q = 0; q < QW; ++q)
              wr[h][j][q] = (u < ub && row < kp && col + 4 * q < n)
                                ? load4(w + row * n, col + 4 * q, n, vec4) : 0u;
          }
          xr[h] = (u < ub && xrow < mt) ? x_word(x + (long long)(m0 + xrow) * k, u, k0, k1)
                                        : 0u;
        }
      };
      auto flush = [&](int gf) {
        int* sd = sdot + (gf - gp0) * rows * COLS;
        // acc[2q + t][e]: column 4·QW·gid + 4q + 2t + e/2, row 2c + e%2
#pragma unroll
        for (int a = 0; a < AR; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * c + (e & 1);
            if (r < mt) atomicAdd(sd + r * COLS + 4 * QW * gid + 2 * a + (e >> 1), acc[a][e]);
          }
      };
      auto run = [&](int i0, const WRegs& wr, const XRegs& xr) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (i0 + b >= it1) break;
          if constexpr (!I8) {
            if (sg == spg) {
              ++g;
              sg = 0;
            }
            ++sg;
            if (g != cur) {
              if (cur >= 0) flush(cur);
#pragma unroll
              for (int a = 0; a < AR; ++a)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[a][e] = 0;
              cur = g;
            }
          }
#pragma unroll
          for (int q = 0; q < QW; ++q) {
            uint32_t cw[2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t r[PR];
#pragma unroll
              for (int j = 0; j < PR; ++j) r[j] = wr[b][h][j][q];
              unit_words_scaled<BITS>(r, cw[h]);
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const uint32_t a[4] = {cw[0][2 * t], cw[0][2 * t + 1], cw[1][2 * t],
                                     cw[1][2 * t + 1]};
              mma_s8(acc[2 * q + t], a, xr[b][0], xr[b][1]);
            }
          }
        }
      };
      auto load_batch = [&](int i0, WRegs& wr, XRegs& xr) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (i0 + b < it1) load(i0 + b, wr[b], xr[b]);
      };

      // two batches in flight: load the next while running this one
      WRegs wa, wb;
      XRegs xa, xb;
      if (it0 < it1) load_batch(it0, wa, xa);
      __syncthreads();                 // sdot is zeroed; the first loads are in flight
      for (int i = it0; i < it1; i += 2 * NB) {
        if (i + NB < it1) load_batch(i + NB, wb, xb);
        run(i, wa, xa);
        if (i + NB >= it1) break;
        if (i + 2 * NB < it1) load_batch(i + 2 * NB, wa, xa);
        run(i + NB, wb, xb);
      }
      if (cur >= 0) flush(cur);
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();

      // the fold, one thread an output, groups in order
      for (int e = threadIdx.x; e < mt * COLS; e += blockDim.x) {
        const int r = e / COLS, cc = e % COLS;
        if (n0 + cc >= n) continue;
        if constexpr (I8) {
          out[(long long)(m0 + r) * n + n0 + cc] =
              __fmul_rn(__fmul_rn((float)sdot[r * COLS + cc], sxs[r]), sws[cc]);
          continue;
        }
        float a = gp0 == 0 ? 0.f : sacc[e];
        for (int gl = 0; gl < gcount; ++gl) {
          const float t = __fmul_rn((float)(sdot[(gl * rows + r) * COLS + cc] >> SHIFT),
                                    sws[gl * COLS + cc]);
          if (terms != nullptr)
            terms[((long long)(gp0 + gl) * m + m0 + r) * n + n0 + cc] = t;
          a = __fadd_rn(a, t);
        }
        if (gp0 + gcount < groups)
          sacc[e] = a;
        else if (out != nullptr)
          out[(long long)(m0 + r) * n + n0 + cc] = __fmul_rn(a, sxs[r]);
      }
      __syncthreads();                 // smem is reused by the next pass or tile
    }
  }
}

template <int BITS, int QW>
__global__ void __launch_bounds__(QK_MAX_THREADS / QW)
qmm_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
           const uint8_t* __restrict__ w, const float* __restrict__ ws,
           float* __restrict__ out, float* __restrict__ terms, int m, int k,
           int n, int groups, long long kp, int spg, int pass_groups, int rows,
           bool vecq, bool vec4, bool xvec, int xs_step, int ws_step) {
  qmm_body<BITS, QW, false>(x, xs, w, ws, out, terms, m, k, n, groups, kp, spg,
                            pass_groups, rows, vecq, vec4, xvec, xs_step, ws_step);
}

// int8_matmul: with 16-column lanes, registers capped for 3 CTAs an SM
template <int QW>
__global__ void __launch_bounds__(QK_MAX_THREADS / QW, QW == 4 ? 3 : 1)
int8_mm_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
               const uint8_t* __restrict__ w, const float* __restrict__ ws,
               float* __restrict__ out, float* __restrict__ terms, int m, int k,
               int n, int groups, long long kp, int spg, int pass_groups, int rows,
               bool vecq, bool vec4, bool xvec, int xs_step, int ws_step) {
  qmm_body<8, QW, true>(x, xs, w, ws, out, terms, m, k, n, groups, kp, spg,
                        pass_groups, rows, vecq, vec4, xvec, xs_step, ws_step);
}

template <int BITS, int QW, bool I8>
constexpr auto qmm_entry() {
  if constexpr (I8) return int8_mm_kernel<QW>;
  else return qmm_kernel<BITS, QW>;
}

template <int BITS, int QW, bool I8 = false>
cudaError_t launch_qmm(const void* x, const void* xs, const void* w,
                       const void* ws, void* out, void* terms, int m, int k,
                       int n, int groups, long long kp, int warps, int spg,
                       int pass_groups, cudaStream_t st, int xs_step = 1,
                       int ws_step = 1) {
  constexpr int COLS = 32 * QW;
  const int rows = m < QK_MT ? m : QK_MT;
  const size_t smem = qmm_smem(pass_groups, rows, COLS);
  const auto kernel = qmm_entry<BITS, QW, I8>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool vecq = n % (4 * QW) == 0 && wp % (4 * QW) == 0;
  const bool vec4 = n % 4 == 0 && wp % 4 == 0;
  const bool xvec = (k % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int mtiles = (m + QK_MT - 1) / QK_MT;
  dim3 grid((n + COLS - 1) / COLS, mtiles < MAX_GRID_Y ? mtiles : MAX_GRID_Y);
  kernel<<<grid, 32 * warps, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(ws),
      static_cast<float*>(out), static_cast<float*>(terms), m, k, n, groups, kp,
      spg, pass_groups, rows, vecq, vec4, xvec, xs_step, ws_step);
  return cudaGetLastError();
}

}  // namespace
