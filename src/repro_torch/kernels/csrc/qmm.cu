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
// Design: one launch (qmm_kernel, in qmm_core.cuh, whose body int8_matmul.cu
// shares) for qmm and for qmm_groups.
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
//    issues two batches of steps before it uses the first, the first
//    before the barrier that orders the zeroing of the shared dots: plain
//    loads (a 4-byte cp.async ring into shared memory measured no faster).
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
