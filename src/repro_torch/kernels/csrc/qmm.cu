// Grouped-scale quantized matmul W{8,6,4,3}A8 and its two halves: the
// per-group scaled partial products and their in-order fold.
//
// Replaces the TPU kernels src/repro/kernels/qmm.py:qmm_pallas
// (_qmm_kernel: (M, K) int8 activations with per-row fp32 scales x a packed
// (K*, N) QTensor payload with (G, N) fp32 group scales -> (M, N) fp32) and
// qmm_groups_pallas (_qmm_groups_kernel: the same product as (G, M, N)
// fp32 terms out[g] = f32(exact int32 dot of group g) * w_scale[g], no
// group sum: the shard-local half of a K-sharded, row-parallel, qmm in
// tensor-parallel serving). On the serving path both are GEMVs (M <= the
// slot count): a few MB of packed weights read once, so what bounds them
// is latency (the weights arrive cold after one DRAM round trip) and, on
// the 95 MB head, the bytes.
//
// Design: one launch (qmm_kernel) for qmm and for qmm_groups.
//  - A CTA owns 32 output columns (a lane 4 of them), or 128 (a lane 16)
//    on the head's N, one tile of up to 8 activation rows, and all of K.
//    Its warps split K: a step is 32 k values of one scale group, and
//    warp w takes a contiguous run of the (group, step) items. The launch
//    plan (kernels/qmm.py) gives 16 warps a CTA while the column tiles
//    fit on the SMs one each, so the small projections keep 16 warps of
//    loads in flight on every SM they use, and 4 on the head.
//  - A lane reads one 32-bit word (or 16 bytes) of each packed row of
//    the 4-k units 2c and 2c + 1 of each step (c = lane % 4): a warp
//    instruction reads 4 rows x 32 (or 128) contiguous bytes. The lane's
//    8 activation bytes of a step are adjacent: one 8-byte load. A warp
//    issues two batches of steps before it uses the first: plain loads
//    (a 4-byte cp.async ring into shared memory measured no faster).
//    unit_words_scaled turns the words into k-contiguous int8 words with
//    byte permutes.
//  - The dot: mma.sync.m16n8k32 s8 with the weights as the A operand (16
//    columns x 32 k) and the activation rows as B (M padded to 8), two
//    mmas a 4-column quad a step. (A __dp4a form against 4 activation
//    rows measured slower on the card: PERF.md § 6.)
//  - A warp adds its int32 dots of a group into shared memory with integer
//    atomics: exact, so the order the warps arrive in does not matter.
//    Then the CTA folds, one thread an output: term[g] =
//    __fmul_rn(f32(dot[g]), ws[g]) (stored when the terms are asked for),
//    acc = __fadd_rn(acc, term[g]) in order g = 0..G-1, and once
//    __fmul_rn(acc, x_scale[row]) (stored when the product is asked for).
//    The group and row scales are staged by cp.async at the start, so the
//    fold waits on nothing cold. More than 64 groups run in passes.
//  - The fast path (every group a whole number of steps, aligned payload
//    and activations: every shape of the serving path) walks per-lane
//    base pointers; any other shape checks each word against its group's
//    units and K and loads it byte by byte where it is ragged.
// No (G, M, N) buffer is written unless the terms are asked for. The
// order of every sum is independent of M and of the tiling of M, so a row
// computed in a batch equals the same row computed alone, bit for bit;
// and terms gathered from K-shards that own whole groups fold
// (qmm_groups_fold_kernel, the tensor-parallel path's combine) to qmm's
// output on the whole K, bit for bit.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md § 6): the
// 1-16 MB projections run at about the time one bf16 library GEMV takes
// on them (0.009-0.022 ms), near the floor of a cold-cache launch; the
// 95-190 MB head at 1.4-1.8 TB/s, short of the byte bound.
#include "qmm_core.cuh"

namespace {

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

template <int BITS, int QW>
__global__ void __launch_bounds__(QK_MAX_THREADS / QW)
qmm_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
           const uint8_t* __restrict__ w, const float* __restrict__ ws,
           float* __restrict__ out, float* __restrict__ terms, int m, int k,
           int n, int groups, long long kp, int spg, int pass_groups, int rows,
           bool vecq, bool vec4, bool xvec) {
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

  for (int m0 = blockIdx.y * MT; m0 < m; m0 += gridDim.y * MT) {
    const int mt = min(MT, m - m0);
    const int8_t* xl = x + (long long)(m0 + xrow) * k + 8 * c;
    for (int gp0 = 0; gp0 < groups; gp0 += pass_groups) {
      const int gcount = min(pass_groups, groups - gp0);
      for (int i = threadIdx.x; i < gcount * COLS; i += blockDim.x) {
        const int cc = i % COLS;
        if (n0 + cc < n) cp_async4(sws + i, ws + (long long)(gp0 + i / COLS) * n + n0 + cc);
      }
      if (out != nullptr && gp0 + gcount >= groups && threadIdx.x < mt)
        cp_async4(sxs + threadIdx.x, xs + m0 + threadIdx.x);
      asm volatile("cp.async.commit_group;\n" ::);
      for (int i = threadIdx.x; i < gcount * rows * COLS; i += blockDim.x) sdot[i] = 0;
      __syncthreads();

      // this warp's (group, step) items: item i is step i % spg of group
      // gp0 + i / spg
      const int items = gcount * spg;
      const int ipw = (items + nwarps - 1) / nwarps;
      const int it0 = min(items, warp * ipw), it1 = min(items, it0 + ipw);
      int acc[AR][4];
      int cur = -1, g = gp0 + it0 / spg, sg = it0 % spg;   // sg: steps of g begun

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
        const int k0 = (gp0 + i / spg) * gs, k1 = k0 + gs;
        const int ub = (k1 + 3) >> 2;             // past the group's last unit
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = (k0 >> 2) + 8 * (i % spg) + 2 * c + h;
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

__global__ void qmm_groups_fold_kernel(const float* __restrict__ terms,
                                       const float* __restrict__ xs,
                                       float* __restrict__ out, int m, int n,
                                       int groups) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)m * n;
  if (idx >= plane) return;
  const int r = (int)(idx / n);
  float acc = 0.f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) acc = __fadd_rn(acc, terms[g * plane + idx]);
  out[idx] = __fmul_rn(acc, xs[r]);
}

template <int BITS, int QW>
cudaError_t launch_qmm(const void* x, const void* xs, const void* w,
                       const void* ws, void* out, void* terms, int m, int k,
                       int n, int groups, long long kp, int warps, int spg,
                       int pass_groups, cudaStream_t st) {
  constexpr int COLS = 32 * QW;
  const int rows = m < QK_MT ? m : QK_MT;
  const size_t smem = qmm_smem(pass_groups, rows, COLS);
  cudaError_t e = allow_smem(qmm_kernel<BITS, QW>, smem);
  if (e != cudaSuccess) return e;
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool vecq = n % (4 * QW) == 0 && wp % (4 * QW) == 0;
  const bool vec4 = n % 4 == 0 && wp % 4 == 0;
  const bool xvec = (k % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int mtiles = (m + QK_MT - 1) / QK_MT;
  dim3 grid((n + COLS - 1) / COLS, mtiles < MAX_GRID_Y ? mtiles : MAX_GRID_Y);
  qmm_kernel<BITS, QW><<<grid, 32 * warps, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(ws),
      static_cast<float*>(out), static_cast<float*>(terms), m, k, n, groups, kp,
      spg, pass_groups, rows, vecq, vec4, xvec);
  return cudaGetLastError();
}

template <int QW>
cudaError_t qmm_by_bits(const void* x, const void* xs, const void* w,
                        const void* ws, void* out, void* terms, int bits, int m,
                        int k, int n, int groups, long long kp, int warps,
                        int spg, int pass_groups, cudaStream_t st) {
  if (bits == 6)
    return launch_qmm<6, QW>(x, xs, w, ws, out, terms, m, k, n, groups, kp, warps,
                             spg, pass_groups, st);
  if (bits == 4 || bits == 3)
    return launch_qmm<4, QW>(x, xs, w, ws, out, terms, m, k, n, groups, kp, warps,
                             spg, pass_groups, st);
  return launch_qmm<8, QW>(x, xs, w, ws, out, terms, m, k, n, groups, kp, warps,
                           spg, pass_groups, st);
}

}  // namespace

// (M, K) int8, (M,) fp32 row scales, packed (kp, N), (G, N) fp32 ->
// ``out`` (M, N) fp32 and/or ``terms`` (G, M, N) fp32 (either may be
// null; ``xs`` only read with ``out``). bits: the QTensor width (8/7/5
// int8 payload, 6, 4/3 nibbles). warps (1..16), spg (k32 steps per group),
// pass_groups (groups a pass holds) and quads (column quads a lane owns:
// 1 or 4) come from the launch plan in kernels/qmm.py, which keeps the
// shared memory within the card's.
extern "C" int qmm_launch(const void* x, const void* xs, const void* w,
                          const void* ws, void* out, void* terms, int bits,
                          long long m, long long k, long long n,
                          long long groups, long long kp, int warps, int spg,
                          int pass_groups, int quads, void* stream) {
  if (warps < 1 || warps * 32 * quads > QK_MAX_THREADS || spg < 1 || pass_groups < 1 ||
      (quads != 1 && quads != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quads == 4)
    return (int)qmm_by_bits<4>(x, xs, w, ws, out, terms, bits, (int)m, (int)k,
                               (int)n, (int)groups, kp, warps, spg, pass_groups, st);
  return (int)qmm_by_bits<1>(x, xs, w, ws, out, terms, bits, (int)m, (int)k,
                             (int)n, (int)groups, kp, warps, spg, pass_groups, st);
}

// (G, M, N) fp32 terms, (M,) fp32 row scales -> (M, N) fp32.
extern "C" int qmm_groups_fold_launch(const void* terms, const void* xs,
                                      void* out, long long m, long long n,
                                      long long groups, void* stream) {
  const long long total = m * n;
  qmm_groups_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(terms), static_cast<const float*>(xs),
      static_cast<float*>(out), (int)m, (int)n, (int)groups);
  return (int)cudaGetLastError();
}
