// Flash attention forward: q (BH, S, D), k/v (BH, T, D) -> o (BH, S, D),
// softmax(q k^T / sqrt(D)) v with an online softmax, causal (aligned
// bottom-right: query i sees keys j <= i + T - S) or full. fp32, bf16 or
// fp16 in and out; fp32 scores, running max, denominator and accumulator;
// P rounded to v's dtype before P·V, as the reference does.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel). Bound by operations: 4·S·T·D
// flops (halved by a causal mask) against (2S + 2T)·D elements moved;
// 6.9e10 flops at B=4, H=16, S=T=2048, D=128 causal, 0.070 ms at the
// H100's 989 TFLOP/s bf16.
//
// Any head dim D <= 256 runs at a kernel width W, the least of {32, 64,
// 96, 128, 256} >= D. Columns D..W-1 are zero: the TMA (or cp.async)
// fills them when a row of D elements is a whole number of 16-byte
// chunks, and otherwise the wrapper hands in copies zero-padded to W
// (``ld`` is the row stride of q, k and v in elements). The scale stays
// 1/sqrt(D) of the true D, and only the first D columns of o are
// written.
//
// bf16 / fp16 (flash_fwd_wgmma_kernel): persistent CTAs, one an SM, each
// walking work tiles (batch·head, 128 query rows) gridDim.x apart, causal
// ones heaviest first, with three warpgroups:
//  - a producer warpgroup, whose first thread loads a work tile's Q and
//    then its K and V tiles (128 keys at W <= 128, 64 above) by TMA into
//    2-stage rings in shared memory. K and V stages have their own
//    "full" mbarriers (signalled with the TMA's byte count) and "empty"
//    ones (one arrival per consumer warp): a K stage frees as soon as its
//    S = Q K^T is done, a V stage a tile later, Q after the work tile's
//    last S = Q K^T, so the next tile's Q and first K load while this
//    one's last P V and stores run.
//  - two consumer warpgroups of 64 query rows each (the wgmma M). Each
//    forms S = Q K^T with wgmma, Q and K both read from shared memory
//    (128- or 64-byte swizzle, the TMA's), keeps m and l in registers,
//    takes P = 2^(S·scale·log2 e - m) (the scale folded into one FMA,
//    ex2.approx on the SFU), masks only the tiles that cross the
//    diagonal or the ragged ends, rounds P to the input dtype in
//    registers and feeds it as the A operand of O += P V (the
//    register-shared wgmma, V read MN-major through the descriptor's
//    transpose bit).
//  Overlap: a warpgroup issues tile j's S = Q K^T together with tile
//  j-1's O += P V and runs tile j's softmax while that P V is on the
//  tensor cores; and the two warpgroups take turns to issue (named
//  barriers, "ping-pong"), so one's softmax runs beside the other's
//  products. setmaxnreg moves registers from the producer (40) to the
//  consumers (232). Causal work runs heaviest first, so the longest rows
//  do not form the tail. Each output row is computed by one CTA in kv
//  order: it does not depend on its batch-mates and is the same from run
//  to run.
// What bounds it now: the tensor cores idle while a warpgroup's first S
// of a work tile has no P V beside it and its last P V has no S, and
// while both warpgroups wait on a load; the softmax (an ex2 and an FMA a
// score, a max and a sum a row) is about half the products' time and
// only the ping-pong hides it.
//
// fp32 (flash_fwd_kernel), which the tensor cores would take only as
// TF32: CUDA-core FMAs, one block per (batch·head, 64-query tile) over
// K/V tiles of 64 keys, cp.async double-buffered (single-buffered at
// W = 256, where two stages do not fit), rows padded by 16 bytes against
// bank conflicts; the same widths, zero columns and causal schedule.
//
// bf16 / fp16 at 256 < D <= 512 (flash_fwd_split_kernel): the same
// warp-specialised wgmma/TMA design with the head dim split between the
// two consumer warpgroups (each owns half of Q, K, V and O's columns for
// the same 64 query rows; the two partial scores are added through shared
// memory). It runs at W = 320, 384, 448 or 512, the least >= D, so each
// half is whole 32-column swizzle blocks; q, k and v are read in place
// under the same rule as up to 256, and the TMA zero-fills the columns
// from their row length up to W.
//
// fp32 at 256 < D <= 512 (flash_fwd_f32_wide_kernel): CUDA-core FMAs,
// Q staged once over the full D, K and V streamed in 64 x 64 chunks
// through two cp.async slots; a block takes a 128-column slab of O (S
// formed again per slab) while the grid is small, and all of O's columns
// (S formed once) once it has two blocks an SM without slabs.
//
// Past D = 512, any dtype (flash_fwd_wide_kernel): CUDA-core FMAs, one
// block per (batch·head, 64-query tile, 128-column slab of O); S = Q K^T
// is formed over the full D in 64-column chunks staged as fp32, so every
// slab recomputes it. No configuration has a head dim past 256.
#include <cuda.h>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float FA_NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;      // 0: zero-fill the chunk
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The query tile a block takes: causal tiles heaviest first.
__device__ __forceinline__ int query_tile(int causal) {
  return causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
}

// ---------------------------------------------------------------------------
// fp32: SIMT. Thread (rg, cg) = (tid / 16, tid % 16) owns query rows
// 4rg..4rg+3; it scores keys cg + 16j (j < 4) and accumulates output
// columns cg·W/16 .. +W/16. A row's max and sum are reduced over its 16
// threads (one half-warp) with xor shuffles; P goes through shared memory.
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;          // query rows per block
constexpr int FA_BKV = 64;         // key/value rows per tile
constexpr int FA_THREADS = 256;
constexpr int FA_PLD = FA_BKV + 4; // padded row of the P tile (floats)
constexpr size_t SMEM_LIMIT = 227 * 1024;

// 64 rows starting at row0 of a (nrows, ld) matrix into a smem tile of W
// columns with rows padded by 16 bytes, by NT threads; rows past nrows
// and columns past dv (a multiple of 4) are zero-filled.
template <int W, int NT>
__device__ __forceinline__ void load_tile(float* sm, const float* __restrict__ g,
                                          int row0, int nrows, int ld, int dv) {
  constexpr int CPR = W / 4;             // 16-byte chunks per row
  constexpr int LD = W + 4;
  for (int c = threadIdx.x; c < FA_BQ * CPR; c += NT) {
    const int r = c / CPR, cc = c % CPR;
    const bool valid = row0 + r < nrows && cc * 4 < dv;
    const float* src = g + (valid ? (long long)(row0 + r) * ld + cc * 4 : 0);
    cp_async16(sm + r * LD + cc * 4, src, valid);
  }
}

// N consecutive floats from smem, with the widest loads their alignment
// (N * 4 bytes) allows.
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int w = 0; w < N / 4; ++w) {
      const float4 u = reinterpret_cast<const float4*>(p)[w];
      out[4 * w] = u.x;
      out[4 * w + 1] = u.y;
      out[4 * w + 2] = u.z;
      out[4 * w + 3] = u.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int w = 0; w < N / 2; ++w) {
      const float2 u = reinterpret_cast<const float2*>(p)[w];
      out[2 * w] = u.x;
      out[2 * w + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = p[j];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int W, int NST>
constexpr size_t smem_bytes_f32() {
  return (size_t)(1 + 2 * NST) * FA_BQ * (W + 4) * sizeof(float) +
         (size_t)FA_BQ * FA_PLD * sizeof(float);
}
template <int W>
constexpr int f32_stages() {
  return smem_bytes_f32<W, 2>() <= SMEM_LIMIT ? 2 : 1;
}

template <int W, int NST>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Tk, int D, int ld, int causal, float scale) {
  constexpr int LD = W + 4;            // padded smem row (elements)
  constexpr int DC = W / 16;           // output columns per thread
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* sQ = reinterpret_cast<float*>(fa_smem);
  float* sK = sQ + FA_BQ * LD;         // NST stages
  float* sV = sK + NST * FA_BKV * LD;  // NST stages
  float* sP = sV + NST * FA_BKV * LD;

  const int bh = blockIdx.x;
  const int q0 = query_tile(causal) * FA_BQ;
  const float* qb = q + (long long)bh * S * ld;
  const float* kb = k + (long long)bh * Tk * ld;
  const float* vb = v + (long long)bh * Tk * ld;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int off = Tk - S;              // bottom-right causal alignment
  const int dv = min(ld, W);           // columns present in memory
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(q0 + FA_BQ, S) + off);
  const int ntiles = (kv_end + FA_BKV - 1) / FA_BKV;

  load_tile<W, FA_THREADS>(sQ, qb, q0, S, ld, dv);
  load_tile<W, FA_THREADS>(sK, kb, 0, Tk, ld, dv);
  load_tile<W, FA_THREADS>(sV, vb, 0, Tk, ld, dv);
  cp_async_commit();

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int st = (NST == 2) ? (it & 1) : 0;
    if (NST == 2 && it + 1 < ntiles) {
      load_tile<W, FA_THREADS>(sK + (st ^ 1) * FA_BKV * LD, kb, (it + 1) * FA_BKV, Tk, ld, dv);
      load_tile<W, FA_THREADS>(sV + (st ^ 1) * FA_BKV * LD, vb, (it + 1) * FA_BKV, Tk, ld, dv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + st * FA_BKV * LD;
    const float* cV = sV + st * FA_BKV * LD;

    // scores of rows 4rg+i against keys cg+16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < W; d0 += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vals<4>(sQ + (rg * 4 + i) * LD + d0, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_vals<4>(cK + (cg + 16 * j) * LD + d0, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qv[i][e], kv[j][e], sc[i][j]);
    }

    // online softmax; P into smem
    const int kv0 = it * FA_BKV;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + rg * 4 + i;
      bool ok[4];
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + cg + 16 * j;
        ok[j] = kp < Tk && (!causal || kp <= qp + off);
        sc[i][j] = ok[j] ? sc[i][j] * scale : FA_NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = half_warp_max(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - mn) : 0.f;
        rs += p;
        sP[(rg * 4 + i) * FA_PLD + cg + 16 * j] = p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P · V over the tile's 64 keys, in key order
#pragma unroll 2
    for (int j0 = 0; j0 < FA_BKV; j0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg * 4 + i) * FA_PLD + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
        load_vals<DC>(cV + (j0 + jj) * LD + cg * DC, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();   // the next iteration refills this stage and sP
    if (NST == 1 && it + 1 < ntiles) {
      load_tile<W, FA_THREADS>(sK, kb, (it + 1) * FA_BKV, Tk, ld, dv);
      load_tile<W, FA_THREADS>(sV, vb, (it + 1) * FA_BKV, Tk, ld, dv);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((long long)bh * S + qp) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (cg * DC + c < D) orow[cg * DC + c] = acc[i][c] / den;
  }
}

// ---------------------------------------------------------------------------
// Head dims above 512, any dtype: CUDA cores, no width to pad to. A block
// owns (batch·head, 64-query tile, a slab of FW_SLAB output columns); it
// forms S = Q K^T over the full D in chunks of FW_DK columns staged as
// fp32 through shared memory, runs the same online softmax as the fp32
// kernel (fp32 m, l and accumulator; P rounded to the input dtype before
// P·V) and accumulates only its slab of O. Every slab recomputes S, so
// the kernel does ceil(D / 128) times the score work; no configuration
// has such a head dim and this kernel is what makes the card take one.
// ---------------------------------------------------------------------------

constexpr int FW_SLAB = 128;       // output columns per block
constexpr int FW_DK = 64;          // head-dim columns per staged chunk of Q and K
constexpr int FW_QLD = FW_DK + 4;  // padded smem rows (floats)
constexpr int FW_VLD = FW_SLAB + 4;
constexpr size_t FW_SMEM =
    ((size_t)(FA_BQ + FA_BKV) * FW_QLD + (size_t)FA_BKV * FW_VLD +
     (size_t)FA_BQ * FA_PLD) * sizeof(float);

// rows [row0, row0 + 64) x columns [c0, c0 + NC) of a (nrows, D) matrix
// into a (64, LD) fp32 smem tile, zero past nrows and D. A thread's loads
// are all issued before its stores (a fixed trip count, unrolled).
template <typename T, int NC, int LD>
__device__ __forceinline__ void stage_f32(float* sm, const T* __restrict__ g,
                                          int row0, int nrows, int c0, int D) {
  constexpr int PER = 64 * NC / FA_THREADS;
  float v[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = threadIdx.x + it * FA_THREADS, r = i / NC, cc = i % NC;
    const bool valid = row0 + r < nrows && c0 + cc < D;
    v[it] = valid ? to_f<T>(g[(long long)(row0 + r) * D + c0 + cc]) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = threadIdx.x + it * FA_THREADS;
    sm[(i / NC) * LD + i % NC] = v[it];
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int Tk, int D, int causal, float scale) {
  constexpr int DC = FW_SLAB / 16;     // output columns per thread
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* sQ = reinterpret_cast<float*>(fa_smem);
  float* sK = sQ + FA_BQ * FW_QLD;
  float* sV = sK + FA_BKV * FW_QLD;
  float* sP = sV + FA_BKV * FW_VLD;

  const int bh = blockIdx.x;
  const int q0 = query_tile(causal) * FA_BQ;
  const int c0 = blockIdx.z * FW_SLAB;
  const T* qb = q + (long long)bh * S * D;
  const T* kb = k + (long long)bh * Tk * D;
  const T* vb = v + (long long)bh * Tk * D;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int off = Tk - S;              // bottom-right causal alignment
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(q0 + FA_BQ, S) + off);
  const int ntiles = (kv_end + FA_BKV - 1) / FA_BKV;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * FA_BKV;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += FW_DK) {
      __syncthreads();                 // the last chunk's (and tile's) readers are done
      stage_f32<T, FW_DK, FW_QLD>(sQ, qb, q0, S, d0, D);
      stage_f32<T, FW_DK, FW_QLD>(sK, kb, kv0, Tk, d0, D);
      if (d0 == 0) stage_f32<T, FW_SLAB, FW_VLD>(sV, vb, kv0, Tk, c0, D);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < FW_DK; dd += 4) {
        float qv[4][4], kv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vals<4>(sQ + (rg * 4 + i) * FW_QLD + dd, qv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) load_vals<4>(sK + (cg + 16 * j) * FW_QLD + dd, kv[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qv[i][e], kv[j][e], sc[i][j]);
      }
    }

    // online softmax; P, rounded to the input dtype, into smem
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + rg * 4 + i;
      bool ok[4];
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + cg + 16 * j;
        ok[j] = kp < Tk && (!causal || kp <= qp + off);
        sc[i][j] = ok[j] ? sc[i][j] * scale : FA_NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = half_warp_max(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - mn) : 0.f;
        rs += p;
        sP[(rg * 4 + i) * FA_PLD + cg + 16 * j] = to_f<T>(from_f<T>(p));
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P · V over the tile's 64 keys, in key order
#pragma unroll 2
    for (int j0 = 0; j0 < FA_BKV; j0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg * 4 + i) * FA_PLD + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
        load_vals<DC>(sV + (j0 + jj) * FW_VLD + cg * DC, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)bh * S + qp) * D + c0;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (c0 + cg * DC + c < D) orow[cg * DC + c] = from_f<T>(acc[i][c] / den);
  }
}

// ---------------------------------------------------------------------------
// fp32, 256 < D <= 512: CUDA cores (the tensor cores would take fp32 only
// as TF32). A block owns (batch·head, 64-query tile, a slab of SW output
// columns); Q is staged once, over the full D; each KV tile's K (for S
// over the full D) and V (for the slab) stream through two shared-memory
// slots of 64 x 64 floats by cp.async, the next chunk loading while this
// one is used. SW = 128 gives ceil(D / 128) slabs, each forming S again,
// for parallelism on small grids; SW = D rounded up to 128 forms S once,
// where the grid has blocks enough without slabs (the launcher decides).
// Thread (rg, cg) = (tid / 16, tid % 16) owns rows 4rg..4rg+3, scores of
// keys cg + 16j, and output columns 64c + 4cg .. +3 of each 64-column
// chunk c of the slab.
// ---------------------------------------------------------------------------

constexpr int FX_CH = 64;                  // rows and columns of a streamed chunk
constexpr int FX_CLD = FX_CH + 4;          // its padded smem row (floats)
constexpr int FX_MAX_D = 512;             // the widest head its launcher takes

constexpr size_t fx_smem_bytes(int dp) {
  return ((size_t)FA_BQ * (dp + 4) + 3 * (size_t)FX_CH * FX_CLD) * sizeof(float);
}

// 64 rows from row0 x 64 columns from col0 of a (nrows, D) fp32 matrix
// into a (64, FX_CLD) smem chunk, zero past nrows and D: 16-byte copies
// when D % 4 == 0 (the rows are then 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void fx_load_chunk(float* sm, const float* __restrict__ g,
                                              int row0, int nrows, int col0, int D,
                                              bool vec, int ld_sm = FX_CLD) {
  if (vec) {
    constexpr int cpr = FX_CH / 4;
    for (int i = threadIdx.x; i < FA_BQ * cpr; i += FA_THREADS) {
      const int r = i / cpr, cc = (i % cpr) * 4;
      const bool valid = row0 + r < nrows && col0 + cc < D;
      const float* src = g + (valid ? (long long)(row0 + r) * D + col0 + cc : 0);
      cp_async16(sm + r * ld_sm + cc, src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < FA_BQ * FX_CH; i += FA_THREADS) {
      const int r = i / FX_CH, cc = i % FX_CH;
      const bool valid = row0 + r < nrows && col0 + cc < D;
      const float* src = g + (valid ? (long long)(row0 + r) * D + col0 + cc : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_u32(sm + r * ld_sm + cc)),
                   "l"(src), "r"(valid ? 4 : 0));
    }
  }
}

template <int SW>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o, int S,
                          int Tk, int D, int causal, float scale, int vec) {
  constexpr int NVC = SW / FX_CH;          // V chunks a KV tile (the slab's)
  const int dp = (D + FX_CH - 1) / FX_CH * FX_CH;
  const int nkc = dp / FX_CH;              // K chunks a KV tile
  const int qld = dp + 4;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* sQ = reinterpret_cast<float*>(fa_smem);
  float* sC = sQ + FA_BQ * qld;             // two chunk slots
  float* sP = sC + 2 * FX_CH * FX_CLD;

  const int bh = blockIdx.x;
  const int q0 = query_tile(causal) * FA_BQ;
  const int c0 = blockIdx.z * SW;
  const float* qb = q + (long long)bh * S * D;
  const float* kb = k + (long long)bh * Tk * D;
  const float* vb = v + (long long)bh * Tk * D;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int off = Tk - S;                  // bottom-right causal alignment
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(q0 + FA_BQ, S) + off);
  const int ntiles = (kv_end + FA_BKV - 1) / FA_BKV;
  const int per_tile = nkc + NVC;          // chunks a KV tile: K over D, then V
  const int nchunks = ntiles * per_tile;

  // chunk g of the stream into slot g & 1
  auto load = [&](int g) {
    const int it = g / per_tile, c = g % per_tile;
    float* dst = sC + (g & 1) * FX_CH * FX_CLD;
    if (c < nkc)
      fx_load_chunk(dst, kb, it * FA_BKV, Tk, c * FX_CH, D, vec);
    else
      fx_load_chunk(dst, vb, it * FA_BKV, Tk, c0 + (c - nkc) * FX_CH, D, vec);
  };
  // Q once, over the full D, with the first chunk
  for (int c = 0; c < nkc; ++c)
    fx_load_chunk(sQ + c * FX_CH, qb, q0, S, c * FX_CH, D, vec, qld);
  if (nchunks > 0) load(0);
  cp_async_commit();

  float m[4], l[4], acc[4][NVC * 4], sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NVC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int g = 0; g < nchunks; ++g) {
    if (g + 1 < nchunks) {
      load(g + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ch = sC + (g & 1) * FX_CH * FX_CLD;
    const int it = g / per_tile, c = g % per_tile;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
    if (c < nkc) {
      // scores of rows 4rg+i against keys cg+16j over this chunk's columns
      const int d0 = c * FX_CH;
#pragma unroll 4
      for (int dd = 0; dd < FX_CH; dd += 4) {
        float qv[4][4], kv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vals<4>(sQ + (rg * 4 + i) * qld + d0 + dd, qv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) load_vals<4>(ch + (cg + 16 * j) * FX_CLD + dd, kv[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qv[i][e], kv[j][e], sc[i][j]);
      }
      if (c == nkc - 1) {
        // online softmax; P into smem (its readers are behind the next
        // chunk's barrier)
        const int kv0 = it * FA_BKV;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = q0 + rg * 4 + i;
          bool ok[4];
          float mx = FA_NEG;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kp = kv0 + cg + 16 * j;
            ok[j] = kp < Tk && (!causal || kp <= qp + off);
            sc[i][j] = ok[j] ? sc[i][j] * scale : FA_NEG;
            mx = fmaxf(mx, sc[i][j]);
          }
          mx = half_warp_max(mx);
          const float mn = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - mn);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ok[j] ? expf(sc[i][j] - mn) : 0.f;
            rs += p;
            sP[(rg * 4 + i) * FA_PLD + cg + 16 * j] = p;
          }
          rs = half_warp_sum(rs);
          l[i] = l[i] * alpha + rs;
          m[i] = mn;
#pragma unroll
          for (int cc = 0; cc < NVC * 4; ++cc) acc[i][cc] *= alpha;
        }
      }
    } else {
      // acc += P · V over the tile's 64 keys, in key order, for this
      // chunk's 4 columns of the thread (a branch a chunk keeps the
      // accumulators' indices constant)
      const int vc = c - nkc;
#pragma unroll
      for (int vi = 0; vi < NVC; ++vi) {
        if (vi != vc) continue;
#pragma unroll 2
        for (int j0 = 0; j0 < FA_BKV; j0 += 4) {
          float4 pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pv[i] = *reinterpret_cast<const float4*>(sP + (rg * 4 + i) * FA_PLD + j0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 vv =
                *reinterpret_cast<const float4*>(ch + (j0 + jj) * FX_CLD + cg * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
              acc[i][vi * 4 + 0] = fmaf(p, vv.x, acc[i][vi * 4 + 0]);
              acc[i][vi * 4 + 1] = fmaf(p, vv.y, acc[i][vi * 4 + 1]);
              acc[i][vi * 4 + 2] = fmaf(p, vv.z, acc[i][vi * 4 + 2]);
              acc[i][vi * 4 + 3] = fmaf(p, vv.w, acc[i][vi * 4 + 3]);
            }
          }
        }
      }
    }
    __syncthreads();                       // slot g & 1 is loaded again at g + 2
  }
  cp_async_wait<0>();                      // Q's copies when there was no chunk

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((long long)bh * S + qp) * D + c0;
#pragma unroll
    for (int vi = 0; vi < NVC; ++vi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = vi * FX_CH + cg * 4 + e;
        if (c0 + col < D) orow[col] = acc[i][vi * 4 + e] / den;
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: warp-specialised wgmma with a TMA-fed ring.
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;                 // query rows per CTA
constexpr int WG_THREADS = 384;            // 2 consumer + 1 producer warpgroup
constexpr int WG_STAGES = 2;
constexpr int WG_CONSUMER_WARPS = 8;       // arrivals that free a ring stage

template <int W>
struct WgCfg {
  static constexpr int CB = (W % 64 == 0) ? 64 : 32;  // columns per swizzle block
  static constexpr int NCB = W / CB;
  static constexpr int ROWB = CB * 2;                  // bytes of a row in a block
  static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : 2;  // wgmma: 128B / 64B swizzle
  static constexpr int BKV = W <= 128 ? 128 : 64;
  static constexpr int Q_BYTES = WG_BQ * W * 2;
  static constexpr int KV_BYTES = BKV * W * 2;        // one of K, V
  static constexpr int TILE_BYTES = Q_BYTES + WG_STAGES * 2 * KV_BYTES;
  // tiles, then 4·STAGES + 2 mbarriers, with room to align the base to 1 KB
  static constexpr size_t SMEM = TILE_BYTES + 128 + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Wait for the phase of the given parity to complete. A wait that lasts
// ~10 s of SM clocks can only be a fault (a missed arrival or a short
// TMA): it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}
// One box of a 3-D tensor map (column, row, batch·head) into smem.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees the registers as written at issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x on the SFU, denormal results flushed to 0 (the softmax's P terms
// below 2^-126 vanish after the bf16/fp16 rounding anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG_CONSUMER_WARPS * 32) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WG_CONSUMER_WARPS * 32) : "memory");
}

// A persistent CTA's work tile w: batch·head and first query row, and
// its number of K/V tiles. Causal work runs heaviest first: every
// batch·head of the last query tile, then of the one before, and so on.
struct WorkTile {
  int bh, q0, ntiles;
};
__device__ __forceinline__ WorkTile work_tile(int w, int bh_count, int nq, int S,
                                              int Tk, int causal, int bkv,
                                              int bq = WG_BQ) {
  const int rank = w / bh_count;
  WorkTile t;
  t.bh = w - rank * bh_count;
  t.q0 = (causal ? nq - 1 - rank : rank) * bq;
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(t.q0 + bq, S) + Tk - S);
  t.ntiles = (kv_end + bkv - 1) / bkv;
  return t;
}

template <typename T, int W>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                       int bh_count, int S, int Tk, int D, int causal,
                       float scale_log2) {
  using C = WgCfg<W>;
  constexpr int BKV = C::BKV;
  constexpr int NS = BKV / 2;            // score accumulators per thread
  constexpr int NO = W / 2;              // output accumulators per thread
  extern __shared__ __align__(16) unsigned char wg_smem[];
  // tiles need 1 KB alignment (the swizzle pattern repeats every 1 KB)
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + WG_BQ * W;                // WG_STAGES tiles of BKV x W
  T* sV = sK + WG_STAGES * BKV * W;
  // K and V ring stages each have their own full and empty barriers: a K
  // stage frees when its S = Q K^T is done, a V stage a tile later; Q
  // frees when a work tile's last S = Q K^T is done
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::TILE_BYTES);
  uint64_t* empty_k = full_k + WG_STAGES;
  uint64_t* full_v = empty_k + WG_STAGES;
  uint64_t* empty_v = full_v + WG_STAGES;
  uint64_t* full_q = empty_v + WG_STAGES;
  uint64_t* empty_q = full_q + 1;

  const int nq = (S + WG_BQ - 1) / WG_BQ;
  const int total = bh_count * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_STAGES; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&empty_k[i], WG_CONSUMER_WARPS);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_v[i], WG_CONSUMER_WARPS);
    }
    mbar_init(full_q, 1);
    mbar_init(empty_q, WG_CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q of each work tile, then its K and V tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int kv = 0;                        // K/V tiles loaded so far: the ring position
      int n = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x, ++n) {
        const WorkTile tile = work_tile(w, bh_count, nq, S, Tk, causal, BKV);
        if (n > 0) mbar_wait(empty_q, (n - 1) & 1);
        mbar_expect_tx(full_q, C::Q_BYTES);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load(sQ + cb * WG_BQ * C::CB, &tq, full_q, cb * C::CB, tile.q0, tile.bh);
        for (int it = 0; it < tile.ntiles; ++it, ++kv) {
          const int st = kv % WG_STAGES;
          const uint32_t free_parity = ((kv / WG_STAGES) & 1) ^ 1;
          T* k_st = sK + st * BKV * W;
          T* v_st = sV + st * BKV * W;
          mbar_wait(&empty_k[st], free_parity);
          mbar_expect_tx(&full_k[st], C::KV_BYTES);
          for (int cb = 0; cb < C::NCB; ++cb)
            tma_load(k_st + cb * BKV * C::CB, &tk, &full_k[st], cb * C::CB, it * BKV,
                     tile.bh);
          mbar_wait(&empty_v[st], free_parity);
          mbar_expect_tx(&full_v[st], C::KV_BYTES);
          for (int cb = 0; cb < C::NCB; ++cb)
            tma_load(v_st + cb * BKV * C::CB, &tv, &full_v[st], cb * C::CB, it * BKV,
                     tile.bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64wg .. +63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 64 * wg + 16 * warp + lane / 4;   // rows r0 and r0 + 8 of the tile
    const int cq = (lane % 4) * 2;                   // first of the two columns it holds
    const int off = Tk - S;                          // bottom-right causal alignment
    int qp0 = 0, qp1 = 0, wg_first = 0;              // of the current work tile

    float o_acc[NO];
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    uint32_t pa[BKV / 16][4];                        // P of the previous tile, A fragments
    float m0, m1, l0, l1;
    const uint32_t q_addr = smem_u32(sQ) + 64 * wg * C::ROWB;
    const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
    constexpr uint32_t SBO = 8 * C::ROWB;            // next 8 rows

    // S = Q K^T over W / 16 k-steps, both from shared memory
    auto gemm_s = [&](int st) {
      const uint32_t k_addr = k_base + st * C::KV_BYTES;
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) {
        const int cb = ks / (C::CB / 16), kin = ks % (C::CB / 16);
        const uint64_t da = wg_desc(q_addr + cb * WG_BQ * C::ROWB + kin * 32, 16,
                                    SBO, C::LAYOUT);
        const uint64_t db = wg_desc(k_addr + cb * BKV * C::ROWB + kin * 32, 16,
                                    SBO, C::LAYOUT);
        Wgmma<T, BKV>::ss(s, da, db, ks > 0);
      }
    };
    // O += P V: P from registers, V MN-major (column blocks LBO apart,
    // 8-key groups SBO apart)
    auto gemm_o = [&](int st) {
      const uint32_t v_addr = v_base + st * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = wg_desc(v_addr + kk * 16 * C::ROWB, BKV * C::ROWB, SBO,
                                    C::LAYOUT);
        Wgmma<T, W>::rs(o_acc, pa[kk], db, 1);
      }
    };
    // The online softmax of K/V tile it on s: masks the tiles that cross
    // the diagonal or the ragged end of T, updates m and this thread's
    // share of l (the quad's sum is taken at the end), leaves 2^(S·scale·
    // log2 e - m) in s and returns the rescale factors of the two rows.
    auto softmax = [&](int it, float& al0, float& al1) {
      const int kv0 = it * BKV;
      if (kv0 + BKV > Tk || (causal && kv0 + BKV - 1 > wg_first + off)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int kp = kv0 + (i / 4) * 8 + cq + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (kp >= Tk || (causal && kp > qp + off)) s[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      const float mb0 = mn0 == -INFINITY ? 0.f : mn0;  // a row with no key yet
      const float mb1 = mn1 == -INFINITY ? 0.f : mn1;
      al0 = ex2(m0 - mb0);
      al1 = ex2(m1 - mb1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        s[i] = ex2(fmaf(s[i], scale_log2, -mb0));
        s[i + 1] = ex2(fmaf(s[i + 1], scale_log2, -mb0));
        s[i + 2] = ex2(fmaf(s[i + 2], scale_log2, -mb1));
        s[i + 3] = ex2(fmaf(s[i + 3], scale_log2, -mb1));
        rs0 += s[i] + s[i + 1];
        rs1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
    };
    // P rounded to T as the A fragments of BKV / 16 k-steps
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barrier 1 + wg is this warpgroup's turn), so one's softmax
    // runs while the other's products keep the tensor cores busy. Both
    // issue ntiles + 1 times per work tile (every work tile has a K/V
    // tile when T > 0); warpgroup 1 hands the first turn over and keeps
    // its last.
    const auto turn_begin = [&]() { named_sync(1 + wg); };
    const auto turn_end = [&](bool last) {
      if (!(last && wg == 1)) named_arrive(2 - wg);
    };
    // a ring stage (or Q) is free once each consumer warp is done with it
    const auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    if (Tk > 0 && wg == 1) named_arrive(1);
    int kv = 0;                          // K/V tiles consumed so far: the ring position
    int n = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x, ++n) {
      const WorkTile tile = work_tile(w, bh_count, nq, S, Tk, causal, BKV);
      const bool last_tile = w + (int)gridDim.x >= total;
      qp0 = tile.q0 + r0;
      qp1 = qp0 + 8;
      wg_first = tile.q0 + 64 * wg;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;

      mbar_wait(full_q, n & 1);
      if (tile.ntiles > 0) {
        float al0, al1;
        const int st0 = kv % WG_STAGES;
        mbar_wait(&full_k[st0], (kv / WG_STAGES) & 1);
        turn_begin();
        fence_regs(s);
        fence_regs(o_acc);
        wg_fence();
        gemm_s(st0);
        wg_commit();
        turn_end(false);
        wg_wait<0>();
        fence_regs(s);
        release(&empty_k[st0]);
        if (tile.ntiles == 1) release(empty_q);
        softmax(0, al0, al1);
        pack_p();
        // K/V tile it's S = Q K^T runs on the tensor cores beside tile
        // it-1's O += P V, and tile it's softmax beside the rest of that P V
        for (int it = 1; it < tile.ntiles; ++it) {
          const int g = kv + it;
          const int st = g % WG_STAGES, pst = (g - 1) % WG_STAGES;
          mbar_wait(&full_k[st], (g / WG_STAGES) & 1);
          mbar_wait(&full_v[pst], ((g - 1) / WG_STAGES) & 1);
          turn_begin();
          fence_regs(s);
          fence_regs(o_acc);
          wg_fence();
          gemm_s(st);
          wg_commit();
          gemm_o(pst);
          wg_commit();
          turn_end(false);
          wg_wait<1>();                // S of tile it
          fence_regs(s);
          release(&empty_k[st]);
          if (it == tile.ntiles - 1) release(empty_q);
          softmax(it, al0, al1);
          wg_wait<0>();                // P V of tile it - 1
          fence_regs(o_acc);
          release(&empty_v[pst]);
#pragma unroll
          for (int i = 0; i < NO; i += 4) {
            o_acc[i] *= al0;
            o_acc[i + 1] *= al0;
            o_acc[i + 2] *= al1;
            o_acc[i + 3] *= al1;
          }
          pack_p();
        }
        const int g = kv + tile.ntiles - 1;
        const int lst = g % WG_STAGES;
        mbar_wait(&full_v[lst], (g / WG_STAGES) & 1);
        turn_begin();
        fence_regs(o_acc);
        wg_fence();
        gemm_o(lst);
        wg_commit();
        turn_end(last_tile);
        wg_wait<0>();
        fence_regs(o_acc);
        release(&empty_v[lst]);
        kv += tile.ntiles;
      } else {
        release(empty_q);
      }

      const float d0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
      const float d1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
      T* o0 = o + ((long long)tile.bh * S + qp0) * D;
      T* o1 = o + ((long long)tile.bh * S + qp1) * D;
      const bool pairs = (D % 2) == 0;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int col = j * 8 + cq;
        if (col >= D) continue;
        const float a = o_acc[4 * j] * d0, b = o_acc[4 * j + 1] * d0;
        const float c = o_acc[4 * j + 2] * d1, e = o_acc[4 * j + 3] * d1;
        if (pairs) {
          if (qp0 < S) *reinterpret_cast<uint32_t*>(o0 + col) = pack2<T>(a, b);
          if (qp1 < S) *reinterpret_cast<uint32_t*>(o1 + col) = pack2<T>(c, e);
        } else {
          if (qp0 < S) {
            o0[col] = from_f<T>(a);
            if (col + 1 < D) o0[col + 1] = from_f<T>(b);
          }
          if (qp1 < S) {
            o1[col] = from_f<T>(c);
            if (col + 1 < D) o1[col + 1] = from_f<T>(e);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16, 256 < D <= 512: the head dim split between two warpgroups.
// One warpgroup cannot hold a 64-row O tile this wide in registers (256
// fp32 a thread at D = 512), so both consumer warpgroups take the same 64
// query rows and warpgroup w owns columns [w·W/2, (w+1)·W/2) of Q, K, V
// and O. Each forms its partial scores S_w = Q_w K_w^T (wgmma, both from
// shared memory, K-depth W/2, N = 32 keys); the two partials meet in
// shared memory behind a named barrier and both warpgroups take S = S_0 +
// S_1 (one IEEE add, the same bits on both sides), run the same online
// softmax and accumulate only their half, O_w += P V_w (rs, N = W/2).
// S is formed once, and each output row is still computed by one CTA in
// key order. Persistent CTAs walk (batch·head, 64-query) work tiles,
// causal ones heaviest first; in the producer warpgroup one thread loads
// each tile's Q and its K tiles and another its V tiles, by TMA into
// 2-stage rings, so a K stage refills as soon as its scores are done. A
// warp whose rows kept their running max skips the rescale of O.
// Columns are in 32-column blocks (64-byte swizzle), so a half (160, 192,
// 224 or 256 columns) starts on a block. Shared memory at W = 512: Q 64
// KB, K and V 2 x 32 KB each, the score exchange 2 x 16 KB: 224 KB.
// What bounds it: neither the loads nor the products (removing either
// leaves most of the time on the prefill shapes) but the chain each
// 32-key tile runs with both warpgroups in step — wait, products,
// exchange, softmax, rescale — with two warps a scheduler to hide it.
// 64-key tiles would halve that chain a key, but fit only one stage of
// K and V and spill at W = 512 (slower on every row measured).
// ---------------------------------------------------------------------------

constexpr int WS_BQ = 64;                  // query rows a work tile (the wgmma M)
constexpr int WS_BKV = 32;                 // keys a K/V tile (the wgmma N of S)
constexpr int WS_CB = 32;                  // columns a swizzle block
constexpr int WS_ROWB = WS_CB * 2;         // bytes of a row in a block
constexpr uint32_t WS_LAYOUT = 2;          // wgmma: 64-byte swizzle

template <int W>
struct WsCfg {
  static_assert(W % (2 * WS_CB) == 0, "kernel width");
  static constexpr int HW = W / 2;         // columns a warpgroup owns
  static constexpr int NCB = W / WS_CB;
  static constexpr int Q_BYTES = WS_BQ * W * 2;
  static constexpr int KV_BYTES = WS_BKV * W * 2;  // one of K, V
  // two exchange buffers of both warpgroups' partial scores, WS_BKV / 2
  // floats a thread
  static constexpr int X_BYTES = 2 * 2 * 128 * (WS_BKV / 2) * 4;
  static constexpr int TILE_BYTES = Q_BYTES + WG_STAGES * 2 * KV_BYTES + X_BYTES;
  static constexpr size_t SMEM = TILE_BYTES + 128 + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

template <typename T, int W>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_split_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                       int bh_count, int S, int Tk, int D, int causal,
                       float scale_log2) {
  using C = WsCfg<W>;
  constexpr int HW = C::HW;
  constexpr int BKV = WS_BKV;
  constexpr int NST = WG_STAGES;
  constexpr int NS = BKV / 2;            // score accumulators per thread
  constexpr int NG = NS / 4;             // ... as float4s
  constexpr int NO = HW / 2;             // output accumulators per thread
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + WS_BQ * W;                // NST tiles of BKV x W
  T* sV = sK + NST * BKV * W;
  // [buffer][warpgroup][NG float4 a thread][128 threads]
  float4* sX = reinterpret_cast<float4*>(sV + NST * BKV * W);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::TILE_BYTES);
  uint64_t* empty_k = full_k + NST;
  uint64_t* full_v = empty_k + NST;
  uint64_t* empty_v = full_v + NST;
  uint64_t* full_q = empty_v + NST;
  uint64_t* empty_q = full_q + 1;

  const int nq = (S + WS_BQ - 1) / WS_BQ;
  const int total = bh_count * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&empty_k[i], WG_CONSUMER_WARPS);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_v[i], WG_CONSUMER_WARPS);
    }
    mbar_init(full_q, 1);
    mbar_init(empty_q, WG_CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producers: one thread loads each work tile's Q and its K
    // tiles, another its V tiles, so a K stage refills as soon as its
    // scores are done, whatever the V ring waits on ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const bool qk = threadIdx.x == 256;
    if (qk || threadIdx.x == 288) {
      int kv = 0;                        // K/V tiles loaded so far: the ring position
      int n = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x, ++n) {
        const WorkTile tile = work_tile(w, bh_count, nq, S, Tk, causal, BKV, WS_BQ);
        if (qk) {
          if (n > 0) mbar_wait(empty_q, (n - 1) & 1);
          mbar_expect_tx(full_q, C::Q_BYTES);
          for (int cb = 0; cb < C::NCB; ++cb)
            tma_load(sQ + cb * WS_BQ * WS_CB, &tq, full_q, cb * WS_CB, tile.q0, tile.bh);
        }
        const CUtensorMap* map = qk ? &tk : &tv;
        T* ring = qk ? sK : sV;
        uint64_t* full = qk ? full_k : full_v;
        uint64_t* empty = qk ? empty_k : empty_v;
        for (int it = 0; it < tile.ntiles; ++it, ++kv) {
          const int st = kv % NST;
          T* dst = ring + st * BKV * W;
          mbar_wait(&empty[st], ((kv / NST) & 1) ^ 1);
          mbar_expect_tx(&full[st], C::KV_BYTES);
          for (int cb = 0; cb < C::NCB; ++cb)
            tma_load(dst + cb * BKV * WS_CB, map, &full[st], cb * WS_CB, it * BKV,
                     tile.bh);
        }
      }
    }
  } else {
    // ---- consumers: both take rows q0 .. q0 + 63; warpgroup wg owns
    // columns c0 .. c0 + HW - 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;             // rows r0 and r0 + 8 of the tile
    const int cq = (lane % 4) * 2;                   // first of the two columns it holds
    const int c0 = wg * HW;
    const int off = Tk - S;                          // bottom-right causal alignment
    int qp0 = 0, qp1 = 0, q_first = 0;               // of the current work tile

    float o_acc[NO];
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    uint32_t pa[BKV / 16][4];                        // P of the previous tile, A fragments
    float m0, m1, l0, l1;
    const uint32_t q_base = smem_u32(sQ), k_base = smem_u32(sK), v_base = smem_u32(sV);
    constexpr uint32_t SBO = 8 * WS_ROWB;            // next 8 rows

    // S_w = Q_w K_w^T over this warpgroup's HW / 16 k-steps
    auto gemm_s = [&](int st) {
      const uint32_t k_addr = k_base + st * C::KV_BYTES;
#pragma unroll
      for (int ks = 0; ks < HW / 16; ++ks) {
        const int col = c0 + 16 * ks;
        const int cb = col / WS_CB, kin = (col % WS_CB) / 16;
        const uint64_t da = wg_desc(q_base + cb * WS_BQ * WS_ROWB + kin * 32, 16, SBO,
                                    WS_LAYOUT);
        const uint64_t db = wg_desc(k_addr + cb * BKV * WS_ROWB + kin * 32, 16, SBO,
                                    WS_LAYOUT);
        Wgmma<T, BKV>::ss(s, da, db, ks > 0);
      }
    };
    // O_w += P V_w: P from registers, V_w MN-major from this warpgroup's
    // first column block (column blocks LBO apart, 8-key groups SBO apart)
    auto gemm_o = [&](int st) {
      const uint32_t v_addr = v_base + st * C::KV_BYTES + (c0 / WS_CB) * BKV * WS_ROWB;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = wg_desc(v_addr + kk * 16 * WS_ROWB, BKV * WS_ROWB, SBO,
                                    WS_LAYOUT);
        Wgmma<T, HW>::rs(o_acc, pa[kk], db, 1);
      }
    };
    // S = S_0 + S_1: this warpgroup's partial out to buffer xn & 1, the
    // other's in. Thread t of either warpgroup holds the same (row, key)
    // entries, so the exchange is thread to thread; one named barrier a
    // tile is enough with two buffers (a buffer is written again two tiles
    // later, after every thread has passed the barrier of the tile
    // between).
    int xn = 0;                                      // exchanges so far
    auto exchange = [&]() {
      float4* mine = sX + ((xn & 1) * 2 + wg) * NG * 128 + t;
      const float4* theirs = sX + ((xn & 1) * 2 + (wg ^ 1)) * NG * 128 + t;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        mine[g * 128] = make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
      named_sync(1);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 u = theirs[g * 128];
        const float v4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * g + e] = wg == 0 ? __fadd_rn(s[4 * g + e], v4[e])
                                 : __fadd_rn(v4[e], s[4 * g + e]);
      }
      ++xn;
    };
    // The online softmax of K/V tile it on s, as in the kernel above.
    auto softmax = [&](int it, float& al0, float& al1) {
      const int kv0 = it * BKV;
      if (kv0 + BKV > Tk || (causal && kv0 + BKV - 1 > q_first + off)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int kp = kv0 + (i / 4) * 8 + cq + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (kp >= Tk || (causal && kp > qp + off)) s[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      const float mb0 = mn0 == -INFINITY ? 0.f : mn0;  // a row with no key yet
      const float mb1 = mn1 == -INFINITY ? 0.f : mn1;
      al0 = ex2(m0 - mb0);
      al1 = ex2(m1 - mb1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NS; i += 4) {
        s[i] = ex2(fmaf(s[i], scale_log2, -mb0));
        s[i + 1] = ex2(fmaf(s[i + 1], scale_log2, -mb0));
        s[i + 2] = ex2(fmaf(s[i + 2], scale_log2, -mb1));
        s[i + 3] = ex2(fmaf(s[i + 3], scale_log2, -mb1));
        rs0 += s[i] + s[i + 1];
        rs1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };
    const auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    int kv = 0;                          // K/V tiles consumed so far: the ring position
    int n = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x, ++n) {
      const WorkTile tile = work_tile(w, bh_count, nq, S, Tk, causal, BKV, WS_BQ);
      qp0 = tile.q0 + r0;
      qp1 = qp0 + 8;
      q_first = tile.q0;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;

      mbar_wait(full_q, n & 1);
      if (tile.ntiles > 0) {
        float al0, al1;
        const int st0 = kv % NST;
        mbar_wait(&full_k[st0], (kv / NST) & 1);
        fence_regs(s);
        fence_regs(o_acc);
        wg_fence();
        gemm_s(st0);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        release(&empty_k[st0]);
        if (tile.ntiles == 1) release(empty_q);
        exchange();
        softmax(0, al0, al1);
        pack_p();
        // K/V tile it's S_w runs on the tensor cores beside tile it-1's
        // O_w += P V_w, and tile it's exchange and softmax beside the rest
        // of that P V
        for (int it = 1; it < tile.ntiles; ++it) {
          const int g = kv + it;
          const int st = g % NST, pst = (g - 1) % NST;
          mbar_wait(&full_k[st], (g / NST) & 1);
          mbar_wait(&full_v[pst], ((g - 1) / NST) & 1);
          fence_regs(s);
          fence_regs(o_acc);
          wg_fence();
          gemm_s(st);
          wg_commit();
          gemm_o(pst);
          wg_commit();
          wg_wait<1>();                // S_w of tile it
          fence_regs(s);
          release(&empty_k[st]);
          if (it == tile.ntiles - 1) release(empty_q);
          exchange();
          softmax(it, al0, al1);
          wg_wait<0>();                // P V_w of tile it - 1
          fence_regs(o_acc);
          release(&empty_v[pst]);
          // a warp whose rows kept their running max skips the rescale
          // (a multiply by 1 changes nothing)
          if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
            for (int i = 0; i < NO; i += 4) {
              o_acc[i] *= al0;
              o_acc[i + 1] *= al0;
              o_acc[i + 2] *= al1;
              o_acc[i + 3] *= al1;
            }
          }
          pack_p();
        }
        const int g = kv + tile.ntiles - 1;
        const int lst = g % NST;
        mbar_wait(&full_v[lst], (g / NST) & 1);
        fence_regs(o_acc);
        wg_fence();
        gemm_o(lst);
        wg_commit();
        wg_wait<0>();
        fence_regs(o_acc);
        release(&empty_v[lst]);
        kv += tile.ntiles;
      } else {
        release(empty_q);
      }

      const float d0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
      const float d1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
      T* o0 = o + ((long long)tile.bh * S + qp0) * D;
      T* o1 = o + ((long long)tile.bh * S + qp1) * D;
      const bool pairs = (D % 2) == 0;
#pragma unroll
      for (int j = 0; j < HW / 8; ++j) {
        const int col = c0 + j * 8 + cq;
        if (col >= D) continue;
        const float a = o_acc[4 * j] * d0, b = o_acc[4 * j + 1] * d0;
        const float c = o_acc[4 * j + 2] * d1, e = o_acc[4 * j + 3] * d1;
        if (pairs) {
          if (qp0 < S) *reinterpret_cast<uint32_t*>(o0 + col) = pack2<T>(a, b);
          if (qp1 < S) *reinterpret_cast<uint32_t*>(o1 + col) = pack2<T>(c, e);
        } else {
          if (qp0 < S) {
            o0[col] = from_f<T>(a);
            if (col + 1 < D) o0[col + 1] = from_f<T>(b);
          }
          if (qp1 < S) {
            o1[col] = from_f<T>(c);
            if (col + 1 < D) o1[col + 1] = from_f<T>(e);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library does not
// link libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (bh, rows, ld) 16-bit tensor as a 3-D map with boxes of (cb, box_rows, 1),
// rows and columns past the tensor read as zero.
bool make_map(CUtensorMap* map, const void* ptr, bool bf16, int bh, int rows,
              int ld, int cb, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ld * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)cb, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      cb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <typename T, int W>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh,
                 int s, int t, int d, int ld, int causal, float scale,
                 cudaStream_t st) {
  using C = WgCfg<W>;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, bf16, bh, s, ld, C::CB, WG_BQ) ||
      !make_map(&mk, k, bf16, bh, t, ld, C::CB, C::BKV) ||
      !make_map(&mv, v, bf16, bh, t, ld, C::CB, C::BKV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<T, W>, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  // persistent: one CTA an SM, each walking work tiles gridDim.x apart
  const long long work = (long long)bh * ((s + WG_BQ - 1) / WG_BQ);
  const int grid = (int)(work < sms ? work : sms);
  flash_fwd_wgmma_kernel<T, W><<<grid, WG_THREADS, C::SMEM, st>>>(
      mq, mk, mv, static_cast<T*>(o), bh, s, t, d, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int W>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int s, int t, int d, int ld, int causal, float scale,
               cudaStream_t st) {
  constexpr int NST = f32_stages<W>();
  constexpr size_t smem = smem_bytes_f32<W, NST>();
  cudaError_t err = allow_smem(flash_fwd_kernel<W, NST>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s + FA_BQ - 1) / FA_BQ);
  flash_fwd_kernel<W, NST><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, t, d, ld, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
           int t, int d, int ld, int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return launch_f32<W>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
  else
    return launch_wgmma<T, W>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
}

// 16-bit, 256 < width <= 512: the split-head-dim kernel at width W (a
// multiple of 64); the TMA zero-fills the columns from ld up to W.
template <typename T, int W>
int launch_split(const void* q, const void* k, const void* v, void* o, int bh,
                 int s, int t, int d, int ld, int causal, float scale,
                 cudaStream_t st) {
  using C = WsCfg<W>;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, bf16, bh, s, ld, WS_CB, WS_BQ) ||
      !make_map(&mk, k, bf16, bh, t, ld, WS_CB, WS_BKV) ||
      !make_map(&mv, v, bf16, bh, t, ld, WS_CB, WS_BKV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_split_kernel<T, W>, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  const long long work = (long long)bh * ((s + WS_BQ - 1) / WS_BQ);
  const int grid = (int)(work < sms ? work : sms);
  flash_fwd_split_kernel<T, W><<<grid, WG_THREADS, C::SMEM, st>>>(
      mq, mk, mv, static_cast<T*>(o), bh, s, t, d, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

// fp32, 256 < D <= 512: slabs of 128 columns while the grid has fewer
// (batch·head, query tile) blocks than two an SM, else one slab of all
// columns (S formed once)
template <int SW>
int launch_f32_wide_sw(const float* q, const float* k, const float* v, float* o,
                       int bh, int s, int t, int d, int causal, float scale,
                       cudaStream_t st) {
  const size_t smem = fx_smem_bytes((d + FX_CH - 1) / FX_CH * FX_CH);
  cudaError_t err = allow_smem(flash_fwd_f32_wide_kernel<SW>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s + FA_BQ - 1) / FA_BQ, (d + SW - 1) / SW);
  const int vec = d % 4 == 0;
  flash_fwd_f32_wide_kernel<SW><<<grid, FA_THREADS, smem, st>>>(q, k, v, o, s, t, d,
                                                                causal, scale, vec);
  return (int)cudaGetLastError();
}

int launch_f32_wide(const void* q, const void* k, const void* v, void* o, int bh,
                    int s, int t, int d, int causal, float scale, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const long long blocks = (long long)bh * ((s + FA_BQ - 1) / FA_BQ);
  if (blocks < 2LL * sms)
    return launch_f32_wide_sw<128>(qf, kf, vf, of, bh, s, t, d, causal, scale, st);
  if (d <= 384)
    return launch_f32_wide_sw<384>(qf, kf, vf, of, bh, s, t, d, causal, scale, st);
  return launch_f32_wide_sw<512>(qf, kf, vf, of, bh, s, t, d, causal, scale, st);
}

// D > 256 outside the split and fp32 kernels' range: q, k, v contiguous
// (bh, rows, d); one block per (batch·head, 64-query tile, 128-column slab
// of O)
template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o, int bh,
                int s, int t, int d, int causal, float scale, cudaStream_t st) {
  cudaError_t err = allow_smem(flash_fwd_wide_kernel<T>, FW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s + FA_BQ - 1) / FA_BQ, (d + FW_SLAB - 1) / FW_SLAB);
  flash_fwd_wide_kernel<T><<<grid, FA_THREADS, FW_SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, d, causal, scale);
  return (int)cudaGetLastError();
}

// the kernels, as kernels/flash_attention.py:KERNELS numbers them; the
// wrapper picks one (kernel_for) and the launcher runs it or refuses
enum Kernel { K_WGMMA = 0, K_SPLIT = 1, K_F32 = 2, K_F32_WIDE = 3, K_WIDE = 4 };

template <typename T>
int launch_k(const void* q, const void* k, const void* v, void* o, int kernel,
             int bh, int s, int t, int d, int ld, int width, int causal,
             float scale, cudaStream_t st) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if ((kernel == K_WGMMA || kernel == K_F32 || kernel == K_SPLIT) &&
      !(d <= ld && ld <= width))
    return (int)cudaErrorInvalidValue;
  switch (kernel) {
    case K_WGMMA:
    case K_F32:
      if (f32 != (kernel == K_F32)) break;
      switch (width) {
        case 32: return launch<T, 32>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
        case 64: return launch<T, 64>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
        case 96: return launch<T, 96>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
        case 128: return launch<T, 128>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
        case 256: return launch<T, 256>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
      }
      break;
    case K_SPLIT:
      if constexpr (!f32) {
        switch (width) {
          case 320: return launch_split<T, 320>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
          case 384: return launch_split<T, 384>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
          case 448: return launch_split<T, 448>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
          case 512: return launch_split<T, 512>(q, k, v, o, bh, s, t, d, ld, causal, scale, st);
        }
      }
      break;
    case K_F32_WIDE:
      if constexpr (f32) {
        if (ld == d && d <= FX_MAX_D)
          return launch_f32_wide(q, k, v, o, bh, s, t, d, causal, scale, st);
      }
      break;
    case K_WIDE:
      if (ld == d) return launch_wide<T>(q, k, v, o, bh, s, t, d, causal, scale, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; kernel: a Kernel, run at a width it
// takes, or the call is refused. q (bh, s, ld), k/v (bh, t, ld),
// contiguous and 16-byte aligned, with d <= ld <= width valid columns
// (zero past d when ld > d); o (bh, s, d). K_WGMMA (16-bit) and K_F32:
// width in {32, 64, 96, 128, 256}; K_SPLIT (16-bit): width in {320, 384,
// 448, 512}; on these ld * element size is a multiple of 16 bytes.
// K_F32_WIDE (fp32, d <= 512) and K_WIDE (any dtype): ld = d, width unused.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int kernel, int bh, int s, int t, int d,
                                      int ld, int width, int causal,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_k<__nv_bfloat16>(q, k, v, o, kernel, bh, s, t, d, ld, width,
                                   causal, scale, st);
  if (dtype == 2)
    return launch_k<__half>(q, k, v, o, kernel, bh, s, t, d, ld, width, causal,
                            scale, st);
  return launch_k<float>(q, k, v, o, kernel, bh, s, t, d, ld, width, causal,
                         scale, st);
}
