// W8A8 int8 matmul: (M, K) int8 activations with per-row fp32 scales x a
// (K, N) row-major int8 weight with per-column fp32 scales -> (M, N) fp32,
// out[m, n] = (f32(acc[m, n]) * x_scale[m]) * w_scale[n], with acc the
// full-K int32 dot.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py:
// int8_matmul_pallas (_int8_mm_kernel). On the serving path it is a GEMV
// (M <= the slot count; prefill replays one-token steps, M = 1), bound by
// the weight bytes, read exactly once: 4 MB on wq (0.0013 ms at 3.35 TB/s
// on the H100 SXM) and 190 MB on the head (0.057 ms). The small
// projections are bound in practice by one cold DRAM round trip and the
// launch, the head by the loads in flight.
//
// Design: one launch, no scratch, the epilogue in the CTA. The weight is
// qmm's W8 payload, so the kernel is qmm's (int8_mm_kernel<QW> in
// qmm_core.cuh: qmm_body<8, QW, true>, described at the top of qmm.cu)
// with one scale group spanning K and int8_matmul's own epilogue:
//  - A CTA owns 32 output columns (a lane 4 of them), or 128 (a lane 16,
//    one 16-byte load a row) where the column tiles outnumber two an SM
//    (the head), one tile of up to 8 activation rows and all of K. Its
//    warps split K into contiguous runs of k32 steps: 16 warps a CTA while
//    the column tiles fit on the SMs one each (wq: 64 CTAs), 4 on the
//    head, whose registers are capped for 3 CTAs an SM. Two batches of
//    steps are in flight before the first is used; transpose4 and
//    mma.sync.m16n8k32 s8 form the dot.
//  - The accumulation is int32 and cannot wrap (the wrapper proves
//    127 * 127 * K < 2^31, so every partial sum is in range too): each
//    warp adds its dots into shared memory with integer atomics, exact in
//    any order. The CTA then applies the epilogue in int8_matmul's order,
//    __fmul_rn(__fmul_rn(f32(acc), xs), ws), not qmm's fold, with the
//    scales staged by cp.async at the start. The result is independent of
//    M, the tiling and the order: bit-identical to the plain version.
//  - Ragged M, K and N are masked in the kernel (a checked path loads
//    them word by word or byte by byte): the weight is never copied to
//    pad it. A scale given as one value is read with stride 0.
#include "qmm_core.cuh"

// x (M, K) int8, xs (M,) fp32 (or one value: xs_step 0), w (K, N) int8,
// ws (N,) fp32 (or one value: ws_step 0), out (M, N) fp32. quads (column
// quads a lane owns: 1, or 4 on the head) and warps (each a contiguous
// run of ceil(steps / warps) k32 steps) come from the launch plan in
// kernels/int8_matmul.py.
extern "C" int int8_matmul_launch(const void* x, const void* xs, const void* w,
                                  const void* ws, void* out, long long m,
                                  long long k, long long n, int quads, int warps,
                                  int xs_step, int ws_step, void* stream) {
  if (warps < 1 || warps * 32 * quads > QK_MAX_THREADS || (quads != 1 && quads != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = (int)((k + 31) / 32);
  if (quads == 4)
    return (int)launch_qmm<8, 4, true>(x, xs, w, ws, out, nullptr, (int)m, (int)k, (int)n, 1,
                                       k, warps, steps, 1, st, xs_step, ws_step);
  return (int)launch_qmm<8, 1, true>(x, xs, w, ws, out, nullptr, (int)m, (int)k, (int)n, 1,
                                     k, warps, steps, 1, st, xs_step, ws_step);
}
