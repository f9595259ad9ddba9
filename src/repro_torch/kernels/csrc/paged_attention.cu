// One-token GQA decode over a paged, optionally quantized KV pool.
//
// q (B, KV, G, Dh) against k/v pages (P, page, KV, Dh') that are fp32,
// bf16, int8 or packed 6/4/3-bit (qtensor byte layout along Dh), read
// through a page table (B, NP) with lengths (B,) and per-page per-kv-head
// scales (P, KV); online fp32 softmax -> (B, KV, G, Dh) in q's dtype.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_attention_pallas
// (_paged_attn_kernel). Bound by bytes: each valid page is read once and
// feeds only 4 * G flops per element, so on the serving path the bound is
// a fraction of a microsecond on the H100 SXM (4 slots of up to 256
// int8 tokens, 8 kv heads: 0.3 MB, 0.0003 ms at 3.35 TB/s) and what
// costs is the launch, the chain of dependent DRAM round trips (length
// and table, then the pages) and the scoring itself.
//
// Design: one launch, the fold in the kernel.
//  - A CTA takes a run of one (slot, kv-head)'s pages; its warps own
//    consecutive pages of that run (the launch plan in
//    kernels/paged_attention.py: pages a warp, warps a CTA, CTAs a (slot,
//    head)). A lane loads a 16-value chunk of one token row (16 bytes of
//    an int8 row, 32 of bf16, 64 of fp32, 12 of 6-bit, 8 of nibbles) with
//    vector loads; a row of Dh = 128 is 8 lanes, so one warp instruction
//    reads 4 token rows. A warp issues a batch of rows (a whole page of
//    Dh = 128 at up to 16 bits) before it uses any; the other pages are
//    in flight in the CTA's other warps and in the other CTAs. The page
//    ids and scales of a warp's pages are read once, one a lane, at the
//    start, without waiting for the length.
//  - It dequantizes in registers (decode_chunk: the arithmetic of the
//    plain version, __fmul_rn(value, scale), with integers turned into
//    floats by byte permutes, not by the SM's slow conversion unit),
//    scores the G query rows
//    (staged in shared memory) with an xor-shuffle sum inside each lane
//    group, and keeps a running fp32 max (one for the warp: a shuffle max
//    a batch), denominator and accumulator in registers; at the end the
//    row groups of the warp add up with a fixed xor butterfly.
//  - The CTA folds its warps' partials in page order in shared memory:
//    M = max m_w, L = sum l_w e^(m_w - M), A = sum acc_w e^(m_w - M).
//    Where a (slot, head)'s valid pages span more than one CTA, each CTA
//    writes its partial to a scratch; the last CTA to finish (an atomic
//    ticket, which it resets to 0) folds them in split order the same
//    way. out = A / max(L, 1e-30).
//  - The split of a (slot, head)'s pages and the order of every fold
//    depend only on NP, the page size, Dh, G and the KV width, never on B
//    or KV: a slot served alone equals the same slot in a batch, and a
//    kv-head shard equals its heads of the full call, bit for bit.
//  - Pages past the slot's length are skipped (under the mask they would
//    add exactly zero) and CTAs with none exit at once; table ids outside
//    [0, P) are clipped, then masked by the length, as the TPU kernel
//    does. Table and lengths are read as given (int32 or int64, any row
//    stride; length = lengths[b] + an offset, so a caller passes
//    positions with offset 1). Dh is any size: rows that are not whole
//    16-value chunks or not aligned take a checked, byte-wise load, and
//    more than two query rows or 512 values a row run in passes.
#include "common.cuh"

namespace {

constexpr int PA_MAX_THREADS = 256;
constexpr int VPC = 16;                  // values of a lane chunk
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// KVMODE: 32 fp32 pages, 16 bf16, 8 int8, 6 packed 6-bit, 4 nibbles (4-
// and 3-bit values). A chunk of 16 values is chunk_words() 32-bit words.
template <int KVMODE>
__host__ __device__ constexpr int chunk_words() {
  return KVMODE == 32 ? 16 : KVMODE == 16 ? 8 : KVMODE == 8 ? 4 : KVMODE == 6 ? 3 : 2;
}
template <int KVMODE>
__host__ __device__ constexpr int elem_bytes() {
  return KVMODE == 32 ? 4 : KVMODE == 16 ? 2 : 1;
}
// rows a lane holds of one batch: a whole int8, packed or bf16 page of
// Dh = 128 (16 rows, 4 lanes-rows x 4), at most 32 words of k and 32 of v
template <int KVMODE>
__host__ __device__ constexpr int batch_rows() {
  return KVMODE == 32 ? 2 : 4;
}

// The chunk at byte ``cb`` of a row of ``rb`` bytes; zero past the row.
template <int KVMODE>
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ row, int cb, int rb,
                                           bool vec, uint32_t (&r)[chunk_words<KVMODE>()]) {
  constexpr int W = chunk_words<KVMODE>();
  const uint8_t* p = row + cb;
  if (vec) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
        r[4 * i] = u.x, r[4 * i + 1] = u.y, r[4 * i + 2] = u.z, r[4 * i + 3] = u.w;
      }
    } else if constexpr (W == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      r[0] = u.x, r[1] = u.y;
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) r[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (cb + 4 * i + b < rb) v |= (uint32_t)p[4 * i + b] << (8 * b);
    r[i] = v;
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* r, int k) {
  return (r[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// byte k of u as the float 2^23 + byte: exact, with no int-to-float
// conversion (the conversion unit is the SM's slowest here)
__device__ __forceinline__ float magic_byte(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k));
}

// 16 values of a chunk in fp32, quantized ones times the page's scale:
// the plain version's __fmul_rn(value, scale), with the integer value
// formed exactly as (2^23 + value + bias) - (2^23 + bias)
template <int KVMODE>
__device__ __forceinline__ void decode_chunk(const uint32_t (&r)[chunk_words<KVMODE>()],
                                             float scale, float (&o)[VPC]) {
  if constexpr (KVMODE == 32) {
#pragma unroll
    for (int i = 0; i < VPC; ++i) o[i] = __uint_as_float(r[i]);
  } else if constexpr (KVMODE == 16) {      // bf16 -> fp32, exact
#pragma unroll
    for (int i = 0; i < VPC / 2; ++i) {
      o[2 * i] = __uint_as_float(r[i] << 16);
      o[2 * i + 1] = __uint_as_float(r[i] & 0xFFFF0000u);
    }
  } else if constexpr (KVMODE == 8) {       // int8 + 128 in each byte
#pragma unroll
    for (int i = 0; i < VPC / 4; ++i) {
      const uint32_t u = r[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o[4 * i + b] = __fmul_rn(__fsub_rn(magic_byte(u, b), 8388736.f), scale);
    }
  } else if constexpr (KVMODE == 4) {       // nibbles, the low one first; + 8 each
#pragma unroll
    for (int i = 0; i < VPC / 8; ++i) {
      const uint32_t lo = (r[i] & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((r[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        o[8 * i + 2 * b] = __fmul_rn(__fsub_rn(magic_byte(lo, b), 8388616.f), scale);
        o[8 * i + 2 * b + 1] = __fmul_rn(__fsub_rn(magic_byte(hi, b), 8388616.f), scale);
      }
    }
  } else {                                  // 4 values in 3 bytes; + 32 each
#pragma unroll
    for (int u = 0; u < VPC / 4; ++u) {
      const uint32_t b0 = byte_of(r, 3 * u), b1 = byte_of(r, 3 * u + 1),
                     b2 = byte_of(r, 3 * u + 2);
      uint32_t v[4];
      v[0] = b0 & 0x3F;
      v[1] = ((b0 >> 6) & 0x3) | ((b1 & 0xF) << 2);
      v[2] = ((b1 >> 4) & 0xF) | ((b2 & 0x3) << 4);
      v[3] = (b2 >> 2) & 0x3F;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * u + e] =
            __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | (v[e] ^ 32u)), 8388640.f), scale);
    }
  }
}

struct Params {
  const void* q;
  long long q_bstride;        // elements between slots of q
  const uint8_t *kp, *vp;
  const void* table;
  long long t_stride;         // entries between rows of the table
  const void* lengths;
  long long l_stride;
  int l_off;                  // length = lengths[b] + l_off
  const float *ks, *vs;       // (P, KV), null for fp pages
  void* out;
  float* part;                // (B·KV, splits, G, 2 + Dh) partials, or null
  int* tickets;               // (B·KV) zeroed counters, or null
  int qbf16, kvh, g, dh, dhp, page, num_pages, np, ppw, splits, lanes_log2,
      chunk_sets, dpad;
  bool vec;
};

template <bool GLOBAL>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  else return *p;
}

// Fold ``count`` softmax partials in order i = 0..count-1 (m and l of
// partial i at i * sml, its acc at i * sacc): M = max m_i,
// L = sum l_i e^(m_i - M), A = sum acc_i e^(m_i - M).
template <bool GLOBAL>
__device__ __forceinline__ void fold(const float* m, const float* l, const float* acc,
                                     int sml, int sacc, int count, float& M, float& L,
                                     float& A) {
  M = NEG_INF;
  for (int i = 0; i < count; ++i) M = fmaxf(M, ld<GLOBAL>(m + i * sml));
  L = 0.f;
  A = 0.f;
  for (int i = 0; i < count; ++i) {
    const float e = __expf(ld<GLOBAL>(m + i * sml) - M);
    L = __fadd_rn(L, __fmul_rn(ld<GLOBAL>(l + i * sml), e));
    A = __fadd_rn(A, __fmul_rn(ld<GLOBAL>(acc + (long long)i * sacc), e));
  }
}

// out[oi] = A / max(L, 1e-30) in q's dtype
__device__ __forceinline__ void store_out(const Params& a, long long oi, float L, float A) {
  const float o = A / fmaxf(L, 1e-30f);
  if (a.qbf16)
    static_cast<__nv_bfloat16*>(a.out)[oi] = __float2bfloat16_rn(o);
  else
    static_cast<float*>(a.out)[oi] = o;
}

// grid (B·KV, splits); block 32 · warps. Shared memory: q [G][dpad],
// the warps' accumulators [warps][G][dpad], maxima and denominators
// [warps][G] each.
template <int KVMODE, typename TI, typename LI>
__global__ void __launch_bounds__(PA_MAX_THREADS)
paged_attn_kernel(const Params a) {
  constexpr int W = chunk_words<KVMODE>();
  constexpr int IPB = batch_rows<KVMODE>();
  extern __shared__ __align__(16) float sm[];
  const int nw = blockDim.x >> 5;
  const int G = a.g, dpad = a.dpad;
  float* qs = sm;
  float* wacc = qs + G * dpad;
  float* wm = wacc + nw * G * dpad;
  float* wl = wm + nw * G;

  const int bh = blockIdx.x, b = bh / a.kvh, h = bh - b * a.kvh;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long len =
      (long long)static_cast<const LI*>(a.lengths)[(long long)b * a.l_stride] + a.l_off;
  const long long npv = len <= 0 ? 0 : min((len + a.page - 1) / a.page, (long long)a.np);
  const int ppc = nw * a.ppw;                      // pages a CTA
  const int nvc = (int)((npv + ppc - 1) / ppc);    // CTAs with valid pages
  if (split >= max(nvc, 1)) return;                // the whole CTA: no barrier reached

  const int lg = a.lanes_log2, lpr = 1 << lg, rpi = 32 >> lg;
  const int rg = lane >> lg, ch = lane & (lpr - 1);
  const int rows_b = IPB * rpi;                    // token rows of a batch
  const int bpp = (a.page + rows_b - 1) / rows_b;  // batches a page
  const int pw0 = split * ppc + warp * a.ppw;
  const int npw = (int)max(0LL, min((long long)a.ppw, npv - pw0));   // the warp's valid pages
  const int nb = npw * bpp;
  const int rb = a.dhp * elem_bytes<KVMODE>();     // bytes of a token row
  const int nc = (a.dh + VPC - 1) / VPC;           // chunks of a row
  constexpr int CB = 4 * W;                        // bytes of a chunk
  const float qscale = 1.0f / sqrtf((float)a.dh);

  // lane j: page pw0 + j's id (clipped) and scales, read without waiting
  // for the length
  int mypid = 0;
  float myks = 1.f, myvs = 1.f;
  if (lane < min(a.ppw, a.np - pw0)) {
    long long id = (long long)static_cast<const TI*>(a.table)[(long long)b * a.t_stride + pw0 + lane];
    id = id < 0 ? 0 : (id >= a.num_pages ? a.num_pages - 1 : id);
    mypid = (int)id;
    if constexpr (KVMODE <= 8) {
      myks = a.ks[(long long)mypid * a.kvh + h];
      myvs = a.vs[(long long)mypid * a.kvh + h];
    }
  }

  struct Batch {
    uint32_t k[IPB][W], v[IPB][W];
  };
  // batch bi: page pw0 + bi / bpp, rows row0 + i·rpi + rg of it; a row
  // is valid inside the page and the slot's length
  auto row_ptr = [&](const uint8_t* pages, int pid, int t) {
    return pages + (((long long)pid * a.page + t) * a.kvh + h) * rb;
  };
  auto rows_ok = [&](int jj, int row0) {
    const int lim = (int)min((long long)a.page, len - (long long)(pw0 + jj) * a.page);
    unsigned ok = 0;
#pragma unroll
    for (int i = 0; i < IPB; ++i) ok |= (row0 + i * rpi + rg < lim ? 1u : 0u) << i;
    return ok;
  };
  auto load_b = [&](int bi, int vset, Batch& B) {
    const int jj = bi / bpp, row0 = (bi - jj * bpp) * rows_b;
    const int pid = __shfl_sync(FULL, mypid, jj);
    const unsigned oks = rows_ok(jj, row0);
    const int kc = ch, vc = vset * lpr + ch;
#pragma unroll
    for (int i = 0; i < IPB; ++i) {
      const int t = row0 + i * rpi + rg;
      const bool ok = (oks >> i) & 1u;
      if (ok && kc < nc) {
        load_chunk<KVMODE>(row_ptr(a.kp, pid, t), kc * CB, rb, a.vec, B.k[i]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) B.k[i][j] = 0u;
      }
      if (ok && vc < nc) {
        load_chunk<KVMODE>(row_ptr(a.vp, pid, t), vc * CB, rb, a.vec, B.v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) B.v[i][j] = 0u;
      }
    }
  };

  bool staged = false;
  for (int g0 = 0; g0 < G; g0 += 2) {
    const int gn = min(2, G - g0);
    for (int vset = 0; vset < a.chunk_sets; ++vset) {
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[2][VPC];
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
#pragma unroll
        for (int v = 0; v < VPC; ++v) acc[gi][v] = 0.f;

      auto compute = [&](int bi, const Batch& B) {
        const int jj = bi / bpp, row0 = (bi - jj * bpp) * rows_b;
        const float ksc = __shfl_sync(FULL, myks, jj), vsc = __shfl_sync(FULL, myvs, jj);
        const int pid = __shfl_sync(FULL, mypid, jj);
        const unsigned oks = rows_ok(jj, row0);
        float s[IPB][2];
#pragma unroll
        for (int i = 0; i < IPB; ++i) {
          float kv[VPC];
          decode_chunk<KVMODE>(B.k[i], ksc, kv);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            float d = 0.f;
            if (gi < gn) {
              const float4* qv = reinterpret_cast<const float4*>(qs + (g0 + gi) * dpad + ch * VPC);
#pragma unroll
              for (int v = 0; v < VPC / 4; ++v) {
                const float4 x = qv[v];
                d = fmaf(x.x, kv[4 * v], d);
                d = fmaf(x.y, kv[4 * v + 1], d);
                d = fmaf(x.z, kv[4 * v + 2], d);
                d = fmaf(x.w, kv[4 * v + 3], d);
              }
            }
            s[i][gi] = d;
          }
          // rows of more than 32 chunks: the chunks past the first 32,
          // loaded here (a row of over 512 values)
          for (int cs = 1; cs < a.chunk_sets; ++cs) {
            const int kc = cs * lpr + ch;
            if (!((oks >> i) & 1u) || kc >= nc) continue;
            uint32_t r[W];
            load_chunk<KVMODE>(row_ptr(a.kp, pid, row0 + i * rpi + rg), kc * CB, rb, a.vec, r);
            decode_chunk<KVMODE>(r, ksc, kv);
#pragma unroll
            for (int gi = 0; gi < 2; ++gi) {
              if (gi >= gn) continue;
              const float* qv = qs + (g0 + gi) * dpad + kc * VPC;
#pragma unroll
              for (int v = 0; v < VPC; ++v) s[i][gi] = fmaf(qv[v], kv[v], s[i][gi]);
            }
          }
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            for (int o = 1; o < lpr; o <<= 1) s[i][gi] += __shfl_xor_sync(FULL, s[i][gi], o);
            s[i][gi] *= qscale;
          }
        }
        float p[IPB][2];
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          if (gi >= gn) continue;
          // the batch's max over the warp's row groups: every lane keeps
          // the same running max, so the warp's combine is a plain sum
          float mb = NEG_INF;
#pragma unroll
          for (int i = 0; i < IPB; ++i)
            if ((oks >> i) & 1u) mb = fmaxf(mb, s[i][gi]);
          for (int o = lpr; o < 32; o <<= 1) mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
          const float mn = fmaxf(m[gi], mb);
          const float al = __expf(m[gi] - mn);
          l[gi] *= al;
#pragma unroll
          for (int v = 0; v < VPC; ++v) acc[gi][v] *= al;
          m[gi] = mn;
#pragma unroll
          for (int i = 0; i < IPB; ++i) {
            p[i][gi] = ((oks >> i) & 1u) ? __expf(s[i][gi] - mn) : 0.f;
            l[gi] += p[i][gi];
          }
        }
#pragma unroll
        for (int i = 0; i < IPB; ++i) {
          if (!((oks >> i) & 1u)) continue;
          float vv[VPC];
          decode_chunk<KVMODE>(B.v[i], vsc, vv);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            if (gi >= gn) continue;
#pragma unroll
            for (int v = 0; v < VPC; ++v) acc[gi][v] = fmaf(p[i][gi], vv[v], acc[gi][v]);
          }
        }
      };

      // a batch's loads all issue before any is used; the warps of the
      // CTA (and the CTAs) keep the other pages in flight
      Batch bt;
      if (nb > 0) load_b(0, vset, bt);
      if (!staged) {
        for (int e = threadIdx.x; e < G * dpad; e += blockDim.x) {
          const int gq = e / dpad, d = e - gq * dpad;
          float v = 0.f;
          if (d < a.dh) {
            const long long o = (long long)b * a.q_bstride + ((long long)h * G + gq) * a.dh + d;
            v = a.qbf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[o])
                        : static_cast<const float*>(a.q)[o];
          }
          qs[e] = v;
        }
        __syncthreads();
        staged = true;
      }
      for (int bi = 0; bi < nb; ++bi) {
        if (bi > 0) load_b(bi, vset, bt);
        compute(bi, bt);
      }

      // the row groups of the warp add up (they share the max): a fixed
      // xor butterfly, whose two sides compute the same sum
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        if (gi >= gn) continue;
        for (int o = lpr; o < 32; o <<= 1) {
          l[gi] += __shfl_xor_sync(FULL, l[gi], o);
#pragma unroll
          for (int v = 0; v < VPC; ++v) acc[gi][v] += __shfl_xor_sync(FULL, acc[gi][v], o);
        }
        if (rg == 0) {
          float4* dst = reinterpret_cast<float4*>(
              wacc + (warp * G + g0 + gi) * dpad + (vset * lpr + ch) * VPC);
#pragma unroll
          for (int v = 0; v < VPC / 4; ++v)
            dst[v] = make_float4(acc[gi][4 * v], acc[gi][4 * v + 1], acc[gi][4 * v + 2],
                                 acc[gi][4 * v + 3]);
          if (lane == 0 && vset == 0) {
            wm[warp * G + g0 + gi] = m[gi];
            wl[warp * G + g0 + gi] = l[gi];
          }
        }
      }
    }
  }
  __syncthreads();

  // the CTA's fold over its warps, in page order; one thread an output
  const int gd = G * a.dh;
  const int bs = G * (2 + a.dh);                   // floats of one CTA partial
  for (int e = threadIdx.x; e < gd; e += blockDim.x) {
    const int gq = e / a.dh, d = e - gq * a.dh;
    float M, L, A;
    fold<false>(wm + gq, wl + gq, wacc + gq * dpad + d, G, G * dpad, nw, M, L, A);
    if (nvc <= 1) {
      store_out(a, (long long)bh * gd + e, L, A);
    } else {
      float* mine = a.part + ((long long)bh * a.splits + split) * bs;
      if (d == 0) {
        mine[gq] = M;
        mine[G + gq] = L;
      }
      mine[2 * G + e] = A;
    }
  }
  if (nvc <= 1) return;

  // more than one CTA: the last to finish folds the CTAs' partials in
  // split order and resets the ticket
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + bh, 1) == nvc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* base = a.part + (long long)bh * a.splits * bs;
  for (int e = threadIdx.x; e < gd; e += blockDim.x) {
    const int gq = e / a.dh;
    float M, L, A;
    fold<true>(base + gq, base + G + gq, base + 2 * G + e, bs, bs, nvc, M, L, A);
    store_out(a, (long long)bh * gd + e, L, A);
  }
  if (threadIdx.x == 0) a.tickets[bh] = 0;
}

template <int KVMODE, typename TI, typename LI>
cudaError_t launch(const Params& p, int b, int warps, size_t smem, cudaStream_t st) {
  cudaError_t e = allow_smem(paged_attn_kernel<KVMODE, TI, LI>, smem);
  if (e != cudaSuccess) return e;
  paged_attn_kernel<KVMODE, TI, LI><<<dim3(b * p.kvh, p.splits), 32 * warps, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename TI, typename LI>
cudaError_t by_mode(int kvmode, const Params& p, int b, int warps, size_t smem,
                    cudaStream_t st) {
  switch (kvmode) {
    case 32: return launch<32, TI, LI>(p, b, warps, smem, st);
    case 16: return launch<16, TI, LI>(p, b, warps, smem, st);
    case 8: return launch<8, TI, LI>(p, b, warps, smem, st);
    case 6: return launch<6, TI, LI>(p, b, warps, smem, st);
    case 4: return launch<4, TI, LI>(p, b, warps, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qtype: 0 = float32, 1 = bfloat16 (q and out; q's slots q_bstride
// elements apart, its (KV, G, Dh) contiguous). kvmode: 32/16 fp pages, 8
// int8, 6 packed 6-bit, 4 nibbles (4- and 3-bit). table (B, NP) and
// lengths (B,) are int32 or int64 (t_bytes, l_bytes: 4 or 8) with row
// strides t_stride, l_stride; length = lengths[b] + l_off. ks/vs: (P, KV)
// fp32, null for fp pages. part and tickets: null unless splits > 1; then
// part holds B·KV·splits·G·(2 + Dh) fp32 and tickets B·KV zeroed int32,
// which the kernel leaves zeroed. ppw, warps, splits, lanes_log2,
// chunk_sets, dpad and smem come from the launch plan in
// kernels/paged_attention.py; vec: whole 16-value chunks, aligned.
extern "C" int paged_attention_launch(
    const void* q, int qtype, long long q_bstride, const void* kp, const void* vp,
    int kvmode, const void* table, int t_bytes, long long t_stride, const void* lengths,
    int l_bytes, long long l_stride, int l_off, const void* ks, const void* vs, void* out,
    void* part, void* tickets, int b, int kvh, int g, int dh, int dhp, int page,
    int num_pages, int np, int ppw, int warps, int splits, int lanes_log2, int chunk_sets,
    int dpad, int smem, int vec, void* stream) {
  if (warps < 1 || warps * 32 > PA_MAX_THREADS || ppw < 1 || ppw > 32 || splits < 1 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) || lanes_log2 < 0 ||
      lanes_log2 > 5 || (t_bytes != 4 && t_bytes != 8) || (l_bytes != 4 && l_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const Params p{q, q_bstride, static_cast<const uint8_t*>(kp),
                 static_cast<const uint8_t*>(vp), table, t_stride, lengths, l_stride, l_off,
                 static_cast<const float*>(ks), static_cast<const float*>(vs), out,
                 static_cast<float*>(part), static_cast<int*>(tickets), qtype, kvh, g, dh,
                 dhp, page, num_pages, np, ppw, splits, lanes_log2, chunk_sets, dpad,
                 vec != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (t_bytes == 4)
    e = l_bytes == 4 ? by_mode<int, int>(kvmode, p, b, warps, smem, st)
                     : by_mode<int, long long>(kvmode, p, b, warps, smem, st);
  else
    e = l_bytes == 4 ? by_mode<long long, int>(kvmode, p, b, warps, smem, st)
                     : by_mode<long long, long long>(kvmode, p, b, warps, smem, st);
  return (int)e;
}
