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
// feeds only 4 * G flops per element. The TPU kernel walks a slot's pages
// in order on one core; here a serial walk by one block per (slot,
// kv-head) left most SMs idle, so the work is split flash-decoding style:
// pass 1 runs one block per (slot, kv-head, page) — the page is loaded
// into shared memory with all of a thread's loads in flight, unpacked and
// multiplied by its (page, head) scale, the G query rows are scored in
// fp32 (one warp per score, fixed shuffle tree) and scaled by Dh^-0.5,
// and the page's softmax partials (max, denominator, accumulator) are
// written in fp32; pass 2 folds them in page order, so the result does
// not depend on scheduling. Pages past the slot's length are skipped:
// under the length mask they would add exactly zero. Table ids outside
// [0, P) are clipped and then masked, as the TPU kernel does; the
// denominator is clamped at 1e-30.
#include "common.cuh"

namespace {

constexpr int PA_THREADS = 128;
constexpr float NEG_INF = -1e30f;

// KVMODE: 32 fp32 pages, 16 bf16 pages, 8 int8, 6 packed 6-bit,
// 4 nibbles (4-bit and 3-bit values). A "unit" is the smallest piece of a
// page row that decodes on its own: one element, one nibble byte (2
// elements) or one 6-bit triple (4 elements).
template <int KVMODE>
__device__ __forceinline__ int units_per_row(int dh, int dhp) {
  return (KVMODE == 6) ? dhp / 3 : (KVMODE == 4 ? dhp : dh);
}

template <int KVMODE>
__device__ __forceinline__ uint32_t raw_unit(const void* pages, long long off, int u) {
  if constexpr (KVMODE == 32) {
    return __float_as_uint(static_cast<const float*>(pages)[off + u]);
  } else if constexpr (KVMODE == 16) {
    return static_cast<const unsigned short*>(pages)[off + u];
  } else if constexpr (KVMODE == 8 || KVMODE == 4) {
    return static_cast<const uint8_t*>(pages)[off + u];
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(pages) + off + 3 * u;
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
  }
}

template <int KVMODE>
__device__ __forceinline__ void decode_unit(uint32_t raw, float scale, float* o, int u) {
  if constexpr (KVMODE == 32) {
    o[u] = __uint_as_float(raw);
  } else if constexpr (KVMODE == 16) {
    o[u] = __uint_as_float(raw << 16);            // bf16 -> fp32, exact
  } else if constexpr (KVMODE == 8) {
    o[u] = __fmul_rn((float)(int8_t)raw, scale);
  } else if constexpr (KVMODE == 4) {
    int lo = raw & 0xF, hi = (raw >> 4) & 0xF;
    lo = lo >= 8 ? lo - 16 : lo;
    hi = hi >= 8 ? hi - 16 : hi;
    o[2 * u] = __fmul_rn((float)lo, scale);
    o[2 * u + 1] = __fmul_rn((float)hi, scale);
  } else {
    const int b0 = raw & 0xFF, b1 = (raw >> 8) & 0xFF, b2 = (raw >> 16) & 0xFF;
    int v[4];
    v[0] = b0 & 0x3F;
    v[1] = ((b0 >> 6) & 0x3) | ((b1 & 0xF) << 2);
    v[2] = ((b1 >> 4) & 0xF) | ((b2 & 0x3) << 4);
    v[3] = (b2 >> 2) & 0x3F;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[4 * u + e] = __fmul_rn((float)(v[e] >= 32 ? v[e] - 64 : v[e]), scale);
  }
}

// Load one page of head h for both k and v into shared memory (fp32,
// dequantized). Each thread first issues up to PA_INFLIGHT loads of k and
// of v, then decodes them, so a page costs about one memory latency.
constexpr int PA_INFLIGHT = 8;

template <int KVMODE>
__device__ __forceinline__ void load_pages(const void* kp, const void* vp, int pid,
                                           int h, int kvh, int page, int dh, int dhp,
                                           float ksc, float vsc, float* kt, float* vt) {
  const int units = units_per_row<KVMODE>(dh, dhp);
  const int items = page * units;
  for (int base = 0; base < items; base += PA_INFLIGHT * blockDim.x) {
    uint32_t rk[PA_INFLIGHT], rv[PA_INFLIGHT];
#pragma unroll
    for (int i = 0; i < PA_INFLIGHT; ++i) {
      const int idx = base + threadIdx.x + i * blockDim.x;
      if (idx < items) {
        const int t = idx / units, u = idx - t * units;
        const long long off = (((long long)pid * page + t) * kvh + h) * dhp;
        rk[i] = raw_unit<KVMODE>(kp, off, u);
        rv[i] = raw_unit<KVMODE>(vp, off, u);
      }
    }
#pragma unroll
    for (int i = 0; i < PA_INFLIGHT; ++i) {
      const int idx = base + threadIdx.x + i * blockDim.x;
      if (idx < items) {
        const int t = idx / units, u = idx - t * units;
        decode_unit<KVMODE>(rk[i], ksc, kt + t * dh, u);
        decode_unit<KVMODE>(rv[i], vsc, vt + t * dh, u);
      }
    }
  }
}

// Pass 1: one block per (slot, kv-head, page). Pages at or past the
// slot's length are skipped (under the length mask they add exactly
// zero). Writes the page's softmax partials: running max m, denominator l
// and the unnormalized accumulator acc = sum_t exp(s_t - m) v_t.
template <typename QT, int KVMODE>
__global__ void __launch_bounds__(PA_THREADS)
paged_attn_partial_kernel(const QT* __restrict__ q, const void* __restrict__ kp,
                          const void* __restrict__ vp, const int* __restrict__ table,
                          const int* __restrict__ lengths, const float* __restrict__ ks,
                          const float* __restrict__ vs, float* __restrict__ pm,
                          float* __restrict__ pl, float* __restrict__ pacc, int kvh,
                          int g, int dh, int dhp, int page, int num_pages, int np) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                      // g * dh
  float* kt = qs + g * dh;             // page * dh
  float* vt = kt + page * dh;          // page * dh
  float* sc = vt + page * dh;          // g * page

  const int b = blockIdx.x / kvh, h = blockIdx.x - (blockIdx.x / kvh) * kvh;
  const int j = blockIdx.y;
  const int len = lengths[b];
  if (j * page >= len) return;         // whole block: no barrier is reached
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const float qscale = 1.0f / sqrtf((float)dh);
  const long long qoff = ((long long)b * kvh + h) * g * dh;

  int pid = table[(long long)b * np + j];
  pid = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
  float ksc = 1.f, vsc = 1.f;
  if constexpr (KVMODE <= 8) {
    ksc = ks[(long long)pid * kvh + h];
    vsc = vs[(long long)pid * kvh + h];
  }
  for (int i = tid; i < g * dh; i += blockDim.x) qs[i] = to_f(q[qoff + i]);
  load_pages<KVMODE>(kp, vp, pid, h, kvh, page, dh, dhp, ksc, vsc, kt, vt);
  __syncthreads();

  for (int idx = warp; idx < g * page; idx += nw) {
    const int gi = idx / page, t = idx - gi * page;
    float p = 0.f;
    for (int d = lane; d < dh; d += 32) p = fmaf(qs[gi * dh + d], kt[t * dh + d], p);
    p = warp_sum(p);
    if (lane == 0) sc[idx] = (j * page + t < len) ? p * qscale : NEG_INF;
  }
  __syncthreads();

  const long long part = ((long long)blockIdx.x * np + j) * g;   // (b, h, j, 0)
  if (tid < g) {
    float mx = NEG_INF;
    for (int t = 0; t < page; ++t) mx = fmaxf(mx, sc[tid * page + t]);
    float l = 0.f;
    for (int t = 0; t < page; ++t) {
      const float e = expf(sc[tid * page + t] - mx);
      sc[tid * page + t] = e;
      l += e;
    }
    pm[part + tid] = mx;
    pl[part + tid] = l;
  }
  __syncthreads();

  for (int d = tid; d < dh; d += blockDim.x)
    for (int gi = 0; gi < g; ++gi) {
      float s = 0.f;
      for (int t = 0; t < page; ++t) s = fmaf(sc[gi * page + t], vt[t * dh + d], s);
      pacc[(part + gi) * dh + d] = s;
    }
}

// Pass 2: one block per (slot, kv-head) folds the page partials in page
// order: out = sum_j acc_j e^(m_j - M) / max(sum_j l_j e^(m_j - M), 1e-30).
template <typename QT>
__global__ void __launch_bounds__(PA_THREADS)
paged_attn_combine_kernel(const int* __restrict__ lengths, const float* __restrict__ pm,
                          const float* __restrict__ pl, const float* __restrict__ pacc,
                          QT* __restrict__ out, int kvh, int g, int dh, int page,
                          int np) {
  const int b = blockIdx.x / kvh;
  int npv = (lengths[b] + page - 1) / page;
  npv = npv < np ? npv : np;
  const long long base = (long long)blockIdx.x * np * g;
  const long long qoff = (long long)blockIdx.x * g * dh;
  for (int gi = 0; gi < g; ++gi) {
    float mx = NEG_INF;
    for (int j = 0; j < npv; ++j) mx = fmaxf(mx, pm[base + j * g + gi]);
    float l = 0.f;
    for (int j = 0; j < npv; ++j) l += pl[base + j * g + gi] * expf(pm[base + j * g + gi] - mx);
    l = fmaxf(l, 1e-30f);
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < npv; ++j)
        acc = fmaf(pacc[(base + j * g + gi) * dh + d],
                   expf(pm[base + j * g + gi] - mx), acc);
      out[qoff + gi * dh + d] = from_f<QT>(acc / l);
    }
  }
}

struct Args {
  const void *q, *kp, *vp, *table, *lengths, *ks, *vs;
  void *out;
  float *pm, *pl, *pacc;
  int b, kvh, g, dh, dhp, page, num_pages, np;
};

template <typename QT, int KVMODE>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t smem = (size_t)(a.g * a.dh + 2 * a.page * a.dh + a.g * a.page) * 4;
  cudaError_t e = allow_smem(paged_attn_partial_kernel<QT, KVMODE>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.b * a.kvh, a.np);
  paged_attn_partial_kernel<QT, KVMODE><<<grid, PA_THREADS, smem, st>>>(
      static_cast<const QT*>(a.q), a.kp, a.vp, static_cast<const int*>(a.table),
      static_cast<const int*>(a.lengths), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), a.pm, a.pl, a.pacc, a.kvh, a.g, a.dh,
      a.dhp, a.page, a.num_pages, a.np);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attn_combine_kernel<QT><<<a.b * a.kvh, PA_THREADS, 0, st>>>(
      static_cast<const int*>(a.lengths), a.pm, a.pl, a.pacc,
      static_cast<QT*>(a.out), a.kvh, a.g, a.dh, a.page, a.np);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t by_mode(int kvmode, const Args& a, cudaStream_t st) {
  switch (kvmode) {
    case 32: return launch<QT, 32>(a, st);
    case 16: return launch<QT, 16>(a, st);
    case 8: return launch<QT, 8>(a, st);
    case 6: return launch<QT, 6>(a, st);
    case 4: return launch<QT, 4>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qtype: 0 = float32, 1 = bfloat16 (q and out). kvmode: 32/16 fp pages,
// 8 int8, 6 packed 6-bit, 4 nibbles (4- and 3-bit). table and lengths
// are int32; scales fp32 (P, KV), ignored for fp pages. pm/pl (B, KV,
// NP, G) and pacc (B, KV, NP, G, Dh) are fp32 scratch for the partials.
extern "C" int paged_attention_launch(const void* q, int qtype, const void* kp,
                                      const void* vp, int kvmode, const void* table,
                                      const void* lengths, const void* ks,
                                      const void* vs, void* out, void* pm, void* pl,
                                      void* pacc, int b, int kvh, int g, int dh,
                                      int dhp, int page, int num_pages, int np,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, kp, vp, table, lengths, ks, vs, out,
               static_cast<float*>(pm), static_cast<float*>(pl),
               static_cast<float*>(pacc), b, kvh, g, dh, dhp, page, num_pages, np};
  cudaError_t e = (qtype == 1) ? by_mode<__nv_bfloat16>(kvmode, a, st)
                               : by_mode<float>(kvmode, a, st);
  return (int)e;
}
