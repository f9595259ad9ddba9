// Grouped ragged quantized matmul for MoE serving, W{8,6,4,3}A8: every
// expert's projection in one launch. (S, C, K) int8 segments with
// (S, C, 1) fp32 row scales x a packed (E, K*, N) expert stack with
// per-expert (E, G, N) fp32 group scales -> (S, C, N) fp32; segment s is
// fed by expert ids[s] and holds counts[s] valid rows; rows past the
// count are exactly 0.0.
//
// Replaces the TPU kernel src/repro/kernels/grouped_qmm.py:
// grouped_qmm_pallas (_grouped_qmm_kernel). Bound by bytes: the packed
// payload and scales of the experts that have rows, read once per 64
// rows, against 2·rows·K·N int8 operations that the tensor cores do in a
// small fraction of that time (at C = 20 on a 2048 x 1024 W4 stack, 47
// experts: 0.018 ms of bytes against 0.001 of operations).
//
// Design: one CTA (4 warps) per (128 output columns, tile of 16, 32 or 64
// rows, segment), the tile the fewest rows that hold C up to 64. It reads
// counts[s] and ids[s] on the device (the host never reads them: no sync
// in the decode loop), writes 0.0 to its rows past the count, and returns
// before reading a weight byte when none is left or the id is outside
// [0, E). Otherwise it walks the scale groups of expert ids[s] in order
// g = 0..G-1, each in chunks of up to 128 logical k values, through a
// 4-stage cp.async ring in shared memory that holds a chunk's packed rows
// of the 128 columns, its activation rows and the group's 128 scales: the
// slab of an expert is read once per row tile. Each warp forms the exact
// int32 group dot of its 32
// columns on the tensor cores (tc_chunk_dots in qmm_core.cuh:
// mma.sync.m16n8k32 s8; its 16-row M fits C = 1..80 better than
// wgmma's 64, and the kernel is bound by bytes, not operations) and
// folds it in registers at the group's end, in group order, with
// qmm.cu's arithmetic: acc = __fadd_rn(acc, __fmul_rn((float)dot,
// ws[e, g, c])), then __fmul_rn(acc, x_scale[row]). The int32 sums are
// exact in any order, so segment s's valid rows equal the qmm kernel on
// expert_slice(w, ids[s]) bit for bit. With a dots buffer the kernel
// also stores each group's int32 dots of the valid rows (the on-card
// check compares them with the plain version).
// What bounds it now: latency, not bytes. A warp's chunk is a dependent
// chain (shared loads, byte permutes, mma.sync) and a CTA walks its
// expert's chunks in turn; the grid holds one warp per 32 columns of each
// active expert, about two per SM scheduler at decode, too few to hide
// that chain, so an expert of 16 chunks a CTA (K = 2048) takes longer
// than one of 8 (K = 1024) with the same bytes.
#include "qmm_core.cuh"

namespace {

constexpr int GQ_STAGES = 4;

// MS: m16 subtiles of a CTA's row tile (1, 2 or 4: 16, 32 or 64 rows),
// the fewest that hold the capacity C, so registers and shared memory
// follow C and more CTAs share an SM at decode.
template <int BITS, int MS>
struct GqCfg {
  static constexpr int ROWS = 16 * MS;
  static constexpr int THREADS = 32 * TC_COL_WARPS;
  static constexpr int W_BYTES = TC_KC / 4 * pack_rows<BITS>() * 128;
  static constexpr int X_BYTES = ROWS * 128;
  static constexpr int S_BYTES = TC_COLS * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES + S_BYTES;
  static constexpr size_t SMEM = (size_t)GQ_STAGES * STAGE;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One chunk into a ring stage: `rows` packed rows of the 128 columns
// starting at wp (row stride n, ncols of them inside the matrix), `mt`
// activation rows of kc values starting at xp (row stride k; zero up to
// TC_KC, so every chunk runs the same 4 k32 steps and the packed rows
// past the chunk meet zeros), the group's 128 scales at sp. The *vec flags
// say the 16-byte copies are aligned; otherwise bytes are copied one by
// one (shapes the serving path does not have).
template <int BITS, int MS>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const uint8_t* wp,
                                            int rows, int ncols, int n,
                                            const int8_t* xp, int mt, int kc, int k,
                                            const float* sp, bool wvec, bool xvec,
                                            bool svec, int tid) {
  constexpr int NT = GqCfg<BITS, MS>::THREADS;
  if (wvec) {
    for (int i = tid; i < rows * 8; i += NT) {
      const int r = i >> 3, b = (i & 7) * 16;
      const bool ok = b < ncols;
      cp_async16(st + w_slab_off<BITS>(r, b), ok ? wp + (long long)r * n + b : wp, ok);
    }
  } else {
    for (int i = tid; i < rows * 128; i += NT) {
      const int r = i >> 7, b = i & 127;
      st[w_slab_off<BITS>(r, b)] = b < ncols ? wp[(long long)r * n + b] : 0;
    }
  }
  unsigned char* xs = st + GqCfg<BITS, MS>::W_BYTES;
  constexpr int kp = TC_KC;
  if (xvec) {
    for (int i = tid; i < mt * (kp >> 4); i += NT) {
      const int r = i / (kp >> 4), b = (i - r * (kp >> 4)) * 16;
      const bool ok = b < kc;
      cp_async16(xs + x_slab_off(r, b), ok ? xp + (long long)r * k + b : xp, ok);
    }
  } else {
    for (int i = tid; i < mt * kp; i += NT) {
      const int r = i / kp, b = i - r * kp;
      xs[x_slab_off(r, b)] = b < kc ? (unsigned char)xp[(long long)r * k + b] : 0;
    }
  }
  float* ss = reinterpret_cast<float*>(xs + GqCfg<BITS, MS>::X_BYTES);
  if (svec) {
    if (tid < TC_COLS / 4) {
      const bool ok = tid * 4 < ncols;
      cp_async16(ss + tid * 4, ok ? sp + tid * 4 : sp, ok);
    }
  } else {
    for (int i = tid; i < TC_COLS; i += NT) ss[i] = i < ncols ? sp[i] : 0.f;
  }
}

template <int BITS, int MS>
__global__ void __launch_bounds__(GqCfg<BITS, MS>::THREADS)
grouped_qmm_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                   const uint8_t* __restrict__ w, const float* __restrict__ ws,
                   const int* __restrict__ counts, const int* __restrict__ ids,
                   float* __restrict__ out, int* __restrict__ dots, int cap,
                   int k, int n, int groups, int experts,
                   long long expert_bytes, bool wvec, bool xvec, bool svec) {
  using Cfg = GqCfg<BITS, MS>;
  constexpr int RPU = pack_rows<BITS>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.z;
  const int m0 = blockIdx.y * Cfg::ROWS;
  const int c0 = blockIdx.x * TC_COLS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int count = min(max(counts[s], 0), cap);
  const int e = ids[s];
  const int tile_rows = min(Cfg::ROWS, cap - m0);
  const int mt = (e < 0 || e >= experts) ? 0 : max(0, min(tile_rows, count - m0));
  const int ncols = min(TC_COLS, n - c0);
  float* ob = out + ((long long)s * cap + m0) * n + c0;

  for (int i = tid; i < (tile_rows - mt) * TC_COLS; i += Cfg::THREADS) {
    const int r = mt + i / TC_COLS, col = i % TC_COLS;
    if (col < ncols) ob[(long long)r * n + col] = 0.f;
  }
  if (mt == 0) return;                  // no weight byte read

  const int gs = k / groups;
  const int cpg = (gs + TC_KC - 1) / TC_KC;       // chunks per group
  const int nchunks = groups * cpg;
  const uint8_t* we = w + (long long)e * expert_bytes + c0;
  const float* wse = ws + (long long)e * groups * n + c0;
  const int8_t* xb = x + ((long long)s * cap + m0) * k;
  const int msub = (mt + 15) >> 4;

  auto issue = [&](int q) {
    const int g = q / cpg, sub = q - g * cpg;
    const int kc0 = g * gs + sub * TC_KC;          // first logical k of the chunk
    const int kc = min(TC_KC, gs - sub * TC_KC);
    stage_chunk<BITS, MS>(smem + (q % GQ_STAGES) * Cfg::STAGE,
                      we + (long long)(kc0 * RPU / 4) * n, kc * RPU / 4, ncols, n,
                      xb + kc0, mt, kc, k, wse + (long long)g * n, wvec, xvec,
                      svec, tid);
  };

  int dot[MS][4][4];
  float acc[MS][4][4];
#pragma unroll
  for (int mi = 0; mi < MS; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dot[mi][i][r] = 0;
        acc[mi][i][r] = 0.f;
      }

#pragma unroll
  for (int q = 0; q < GQ_STAGES - 1; ++q) {
    if (q < nchunks) issue(q);
    cp_async_commit();
  }
  const int gid = lane >> 2, cq = lane & 3;
  const int lcol = 32 * warp + 8 * cq;             // first of the lane's 8 columns
  for (int q = 0; q < nchunks; ++q) {
    cp_async_wait<GQ_STAGES - 2>();
    __syncthreads();                    // chunk q landed; stage q - 1 is free
    if (q + GQ_STAGES - 1 < nchunks) issue(q + GQ_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (q % GQ_STAGES) * Cfg::STAGE;
    const int g = q / cpg, sub = q - g * cpg;
    tc_chunk_dots<BITS, MS>(
        st, static_cast<uint32_t>(__cvta_generic_to_shared(st + Cfg::W_BYTES)), msub,
        warp, lane, dot);
    if (sub != cpg - 1) continue;
    // the group's end: fold its dots in group order
    const float* sc = reinterpret_cast<const float*>(st + Cfg::W_BYTES + Cfg::X_BYTES);
    const float4 sa = *reinterpret_cast<const float4*>(sc + lcol);
    const float4 sb = *reinterpret_cast<const float4*>(sc + lcol + 4);
    const float wsv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
    for (int mi = 0; mi < MS; ++mi) {
      if (mi >= msub) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * (r & 1) + i;           // column lcol + j
          acc[mi][i][r] = __fadd_rn(acc[mi][i][r],
                                    __fmul_rn((float)dot[mi][i][r], wsv[j]));
          if (dots != nullptr) {
            const int row = mi * 16 + gid + 8 * (r >> 1);
            if (row < mt && lcol + j < ncols)
              dots[(((long long)s * groups + g) * cap + m0 + row) * n + c0 + lcol + j] =
                  dot[mi][i][r];
          }
          dot[mi][i][r] = 0;
        }
    }
  }

  const bool vec_out = (n % 4) == 0 && lcol + 8 <= ncols;
#pragma unroll
  for (int mi = 0; mi < MS; ++mi) {
    if (mi >= msub) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mi * 16 + gid + 8 * h;
      if (row >= mt) continue;
      const float xsr = xs[(long long)s * cap + m0 + row];
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = __fmul_rn(acc[mi][i][2 * h], xsr);
        v[4 + i] = __fmul_rn(acc[mi][i][2 * h + 1], xsr);
      }
      float* orow = ob + (long long)row * n + lcol;
      if (vec_out) {
        reinterpret_cast<float4*>(orow)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(orow)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (lcol + j < ncols) orow[j] = v[j];
      }
    }
  }
}

template <int BITS, int MS>
cudaError_t launch_ms(const void* x, const void* xs, const void* w, const void* ws,
                      const void* counts, const void* ids, void* out, void* dots,
                      int segs, int cap, int k, int n, int groups, int experts,
                      long long expert_bytes, cudaStream_t st) {
  using Cfg = GqCfg<BITS, MS>;
  constexpr size_t smem = Cfg::SMEM;
  cudaError_t e = allow_smem(grouped_qmm_kernel<BITS, MS>, smem);
  if (e != cudaSuccess) return e;
  const int gs = k / groups;
  const bool wvec = n % 16 == 0 && expert_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = k % 16 == 0 && gs % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool svec = n % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  const dim3 grid((n + TC_COLS - 1) / TC_COLS, (cap + Cfg::ROWS - 1) / Cfg::ROWS,
                  segs);
  grouped_qmm_kernel<BITS, MS><<<grid, Cfg::THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(ws),
      static_cast<const int*>(counts), static_cast<const int*>(ids),
      static_cast<float*>(out), static_cast<int*>(dots), cap, k, n, groups,
      experts, expert_bytes, wvec, xvec, svec);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch(const void* x, const void* xs, const void* w, const void* ws,
                   const void* counts, const void* ids, void* out, void* dots,
                   int segs, int cap, int k, int n, int groups, int experts,
                   long long expert_bytes, cudaStream_t st) {
  if (cap <= 16)
    return launch_ms<BITS, 1>(x, xs, w, ws, counts, ids, out, dots, segs, cap, k,
                              n, groups, experts, expert_bytes, st);
  if (cap <= 32)
    return launch_ms<BITS, 2>(x, xs, w, ws, counts, ids, out, dots, segs, cap, k,
                              n, groups, experts, expert_bytes, st);
  return launch_ms<BITS, 4>(x, xs, w, ws, counts, ids, out, dots, segs, cap, k, n,
                            groups, experts, expert_bytes, st);
}

}  // namespace

// bits: the QTensor width (8/7/5 int8 payload, 6, 4/3 nibbles);
// expert_bytes: packed payload bytes of one expert (K* x N). ``dots`` is
// null, or an (S, G, C, N) int32 buffer that receives the group dots of
// the rows below each segment's count.
extern "C" int grouped_qmm_launch(const void* x, const void* xs, const void* w,
                                  const void* ws, const void* counts,
                                  const void* ids, void* out, void* dots,
                                  int bits, long long segs, long long cap,
                                  long long k, long long n, long long groups,
                                  long long experts, long long expert_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int a = (int)segs, c = (int)cap, kk = (int)k, nn = (int)n;
  const int g = (int)groups, ex = (int)experts;
  cudaError_t e;
  if (bits == 6)
    e = launch<6>(x, xs, w, ws, counts, ids, out, dots, a, c, kk, nn, g, ex,
                  expert_bytes, st);
  else if (bits == 4 || bits == 3)
    e = launch<4>(x, xs, w, ws, counts, ids, out, dots, a, c, kk, nn, g, ex,
                  expert_bytes, st);
  else
    e = launch<8>(x, xs, w, ws, counts, ids, out, dots, a, c, kk, nn, g, ex,
                  expert_bytes, st);
  return (int)e;
}
