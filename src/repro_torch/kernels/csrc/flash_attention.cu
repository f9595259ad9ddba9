// Flash attention forward: q (BH, S, D), k/v (BH, T, D) -> o (BH, S, D),
// softmax(q k^T / sqrt(D)) v with an online softmax, causal (aligned
// bottom-right: query i sees keys j <= i + T - S) or full. fp32, bf16 or
// fp16 in and out; fp32 scores, running max, denominator and accumulator;
// P rounded to v's dtype before P·V, as the reference does.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel). Bound by operations at the
// model's shapes (4·S·T·D flops against (2S + 2T)·D elements moved;
// 6.9e10 flops at B=4, H=16, S=T=2048, D=128 causal).
//
// Design, common to both kernels:
//  - One block per (batch·head, 64-query tile). The TPU grid's sequential
//    kv axis becomes a loop inside the block over K/V tiles of 64 rows,
//    staged in shared memory (rows padded by 16 bytes against bank
//    conflicts) and double-buffered with cp.async: tile i+1 is in flight
//    while tile i is used. m, l and the accumulator stay in registers.
//  - Causal: the loop stops at the last tile the tile's last query row
//    can see instead of masking whole tiles; within a tile, and for the
//    ragged S and T tails, entries are masked in the kernel (the TPU
//    wrapper's padding is not masked). Masked probabilities are exactly
//    0, and every row's first tile holds a visible key (S <= T).
//  - Each output row is computed by one block in kv order, so it does not
//    depend on its batch-mates and is the same from run to run.
// bf16/fp16 run both products on the tensor cores (flash_fwd_mma_kernel,
// mma.sync); fp32 inputs, which the tensor cores take only as TF32, run
// them as fp32 FMAs on the CUDA cores (flash_fwd_kernel).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int FA_BQ = 64;          // query rows per block
constexpr int FA_BKV = 64;         // key/value rows per tile
constexpr int FA_THREADS = 256;
constexpr int FA_PLD = FA_BKV + 4; // padded row of the P tile (floats)
constexpr float FA_NEG = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;      // 0: zero-fill the row's chunk
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 64 rows starting at row0 of a (nrows, D) matrix into a smem tile with
// rows padded by 16 bytes, by NT threads; rows past nrows are zero-filled.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
                                          int row0, int nrows) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int CPR = D / VE;            // 16-byte chunks per row
  constexpr int LD = D + VE;
  for (int c = threadIdx.x; c < FA_BQ * CPR; c += NT) {
    const int r = c / CPR, cc = c % CPR;
    const bool valid = row0 + r < nrows;
    const T* src = g + (long long)(valid ? row0 + r : 0) * D + cc * VE;
    cp_async16(sm + r * LD + cc * VE, src, valid);
  }
}

// N consecutive elements from smem, with the widest loads their alignment
// (N * sizeof(T) bytes) allows.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&out)[N]) {
  constexpr int B = N * (int)sizeof(T);
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int w = 0; w < B / 16; ++w) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[w];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < 16 / (int)sizeof(T); ++j)
        out[w * (16 / sizeof(T)) + j] = to_f(e[j]);
    }
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  } else if constexpr (B == 4) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(p[j]);
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

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)5 * FA_BQ * (D + 16 / sizeof(T)) * sizeof(T) +
         (size_t)FA_BQ * FA_PLD * sizeof(float);
}

// ---------------------------------------------------------------------------
// fp32: SIMT. Thread (rg, cg) = (tid / 16, tid % 16) owns query rows
// 4rg..4rg+3; it scores keys cg + 16j (j < 4) and accumulates output
// columns cg·D/16 .. +D/16. A row's max and sum are reduced over its 16
// threads (one half-warp) with xor shuffles; P goes through shared memory.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int causal, float scale) {
  constexpr int VE = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int LD = D + VE;           // padded smem row (elements)
  constexpr int DC = D / 16;           // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + FA_BQ * LD;             // two stages
  T* sV = sK + 2 * FA_BKV * LD;        // two stages
  float* sP = reinterpret_cast<float*>(sV + 2 * FA_BKV * LD);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FA_BQ;
  const T* qb = q + (long long)bh * S * D;
  const T* kb = k + (long long)bh * Tk * D;
  const T* vb = v + (long long)bh * Tk * D;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int off = Tk - S;              // bottom-right causal alignment
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(q0 + FA_BQ, S) + off);
  const int ntiles = (kv_end + FA_BKV - 1) / FA_BKV;

  load_tile<T, D, FA_THREADS>(sQ, qb, q0, S);
  load_tile<T, D, FA_THREADS>(sK, kb, 0, Tk);
  load_tile<T, D, FA_THREADS>(sV, vb, 0, Tk);
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
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<T, D, FA_THREADS>(sK + (st ^ 1) * FA_BKV * LD, kb, (it + 1) * FA_BKV, Tk);
      load_tile<T, D, FA_THREADS>(sV + (st ^ 1) * FA_BKV * LD, vb, (it + 1) * FA_BKV, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + st * FA_BKV * LD;
    const T* cV = sV + st * FA_BKV * LD;

    // scores of rows 4rg+i against keys cg+16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += VE) {
      float qv[4][VE], kv[4][VE];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vals<T, VE>(sQ + (rg * 4 + i) * LD + d0, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_vals<T, VE>(cK + (cg + 16 * j) * LD + d0, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) sc[i][j] = fmaf(qv[i][e], kv[j][e], sc[i][j]);
    }

    // online softmax; P rounded to T into smem
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
        sP[(rg * 4 + i) * FA_PLD + cg + 16 * j] = to_f(from_f<T>(p));
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
        load_vals<T, DC>(cV + (j0 + jj) * LD + cg * DC, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();   // the next iteration refills this stage and sP
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)bh * S + qp) * D + cg * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = from_f<T>(acc[i][c] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the two products on the tensor cores (mma.sync m16n8k16,
// fp32 accumulate). Four warps, each owning 16 of the block's 64 query
// rows: Q is held as A fragments in registers, K and V tiles come from
// the same cp.async double buffer through ldmatrix (V transposed), and P
// goes from the score accumulators straight into the A fragments of P·V
// (rounded to the input dtype on the way), never through shared memory.
// A row's max and sum are reduced over the 4 lanes that hold it.
// ---------------------------------------------------------------------------

constexpr int FM_THREADS = 128;

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int D>
constexpr size_t smem_bytes_mma() {
  return (size_t)5 * FA_BQ * (D + 8) * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(FM_THREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                     int causal, float scale) {
  constexpr int LD = D + 8;            // padded smem row (elements)
  constexpr int KS = D / 16;           // k-steps of Q·K^T
  constexpr int NO = D / 8;            // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + FA_BQ * LD;             // two stages
  T* sV = sK + 2 * FA_BKV * LD;        // two stages

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FA_BQ;
  const T* qb = q + (long long)bh * S * D;
  const T* kb = k + (long long)bh * Tk * D;
  const T* vb = v + (long long)bh * Tk * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = Tk - S;              // bottom-right causal alignment
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(q0 + FA_BQ, S) + off);
  const int ntiles = (kv_end + FA_BKV - 1) / FA_BKV;

  load_tile<T, D, FM_THREADS>(sQ, qb, q0, S);
  load_tile<T, D, FM_THREADS>(sK, kb, 0, Tk);
  load_tile<T, D, FM_THREADS>(sV, vb, 0, Tk);
  cp_async_commit();

  // rows of this thread: r0 = warp*16 + lane/4 and r0 + 8
  const int qp0 = q0 + warp * 16 + (lane >> 2);
  const int qp1 = qp0 + 8;
  const int cq = (lane & 3) * 2;       // first of the two columns it holds
  float m0 = FA_NEG, m1 = FA_NEG, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qa[KS][4];

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<T, D, FM_THREADS>(sK + (st ^ 1) * FA_BKV * LD, kb,
                                    (it + 1) * FA_BKV, Tk);
      load_tile<T, D, FM_THREADS>(sV + (st ^ 1) * FA_BKV * LD, vb,
                                    (it + 1) * FA_BKV, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qa[ks], sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
    }
    const T* cK = sK + st * FA_BKV * LD;
    const T* cV = sV + st * FA_BKV * LD;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        const int m = lane >> 3;
        ldsm_x4(b, cK + (np * 16 + (m >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (m & 1) * 8);
        Mma<T>::run(s[2 * np], qa[ks], b[0], b[1]);
        Mma<T>::run(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }

    // online softmax of rows qp0 (s[j][0..1]) and qp1 (s[j][2..3])
    const int kv0 = it * FA_BKV;
    float mx0 = FA_NEG, mx1 = FA_NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kv0 + j * 8 + cq + e;
        const bool in = kp < Tk;
        const bool ok0 = in && (!causal || kp <= qp0 + off);
        const bool ok1 = in && (!causal || kp <= qp1 + off);
        s[j][e] = ok0 ? s[j][e] * scale : FA_NEG;
        s[j][2 + e] = ok1 ? s[j][2 + e] * scale : FA_NEG;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[4][4];                 // P as the A fragments of 4 k-steps
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = s[j][e] > 0.5f * FA_NEG ? expf(s[j][e] - mn0) : 0.f;
        p[2 + e] = s[j][2 + e] > 0.5f * FA_NEG ? expf(s[j][2 + e] - mn1) : 0.f;
      }
      rs0 += p[0] + p[1];
      rs1 += p[2] + p[3];
      pa[j >> 1][(j & 1) * 2] = Mma<T>::pack(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }

    // acc += P V: 4 k-steps of 16 keys, NO n-tiles of 8 columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        const int m = lane >> 3;
        ldsm_x4_t(b, cV + (kk * 16 + (m & 1) * 8 + (lane & 7)) * LD + np * 16 + (m >> 1) * 8);
        Mma<T>::run(acc[2 * np], pa[kk], b[0], b[1]);
        Mma<T>::run(acc[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();   // the next iteration refills this stage
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + cq;
    if (qp0 < S) {
      T* p0 = o + ((long long)bh * S + qp0) * D + col;
      p0[0] = from_f<T>(acc[j][0] / d0);
      p0[1] = from_f<T>(acc[j][1] / d0);
    }
    if (qp1 < S) {
      T* p1 = o + ((long long)bh * S + qp1) * D + col;
      p1[0] = from_f<T>(acc[j][2] / d1);
      p1[1] = from_f<T>(acc[j][3] / d1);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int t, int causal, float scale, cudaStream_t st) {
  const dim3 grid((s + FA_BQ - 1) / FA_BQ, bh);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = smem_bytes<T, D>();
    cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<T, D><<<grid, FA_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), s, t, causal, scale);
  } else {
    const size_t smem = smem_bytes_mma<T, D>();
    cudaError_t err = allow_smem(flash_fwd_mma_kernel<T, D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma_kernel<T, D><<<grid, FM_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), s, t, causal, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int t, int d, int causal, float scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, s, t, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, t, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, t, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; q (bh, s, d), k/v (bh, t, d), contiguous
// and 16-byte aligned; d in {32, 64, 128}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int bh, int s, int t, int d, int causal,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_d<__nv_bfloat16>(q, k, v, o, bh, s, t, d, causal, scale, st);
  if (dtype == 2) return launch_d<__half>(q, k, v, o, bh, s, t, d, causal, scale, st);
  return launch_d<float>(q, k, v, o, bh, s, t, d, causal, scale, st);
}
