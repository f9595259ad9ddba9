"""The port's kernels on the CPU (their plain PyTorch versions) against
repro.kernels.ref and the Pallas kernels in interpret mode; the CUDA
kernels themselves are held against the same plain versions on the card
by chip_smoke.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import qtensor as jq
from repro.kernels import ref as jref
from repro.kernels.ef_sqnorm import ef_sqnorm_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.qmm import qmm_pallas
from repro_torch import qtensor as tq
from repro_torch.kernels import ef_sqnorm as kef, ops, qmm as kqmm, ref as tref


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ef_sqnorm(dtype):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, 3000)).astype(np.float32)
    gj = jnp.asarray(g, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32)))
    if dtype == "bfloat16":
        gt = gt.to(torch.bfloat16)
    got = ops.ef_sqnorm(gt).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.ef_sqnorm(gj)), rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ef_sqnorm_pallas(gj, interpret=True)),
                               rtol=1e-5)
    assert got.dtype == np.float32


@pytest.mark.parametrize("bits", (8, 6, 4, 3))
@pytest.mark.parametrize("group_size", [None, 16])
def test_qmm(bits, group_size):
    rng = np.random.default_rng(bits)
    k, n, m = 64, 48, 3
    w = rng.normal(size=(k, n)).astype(np.float32)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    xs = (rng.random((m, 1)) * 0.1 + 0.01).astype(np.float32)
    wj = jq.quantize(jnp.asarray(w), bits, group_size=group_size)
    wt = tq.quantize(torch.from_numpy(w), bits, group_size=group_size)
    # exact int32 group products
    np.testing.assert_array_equal(
        tref.qmm_group_products(torch.from_numpy(xq), wt).numpy(),
        np.asarray(jref.qmm_group_products(jnp.asarray(xq), wj)))
    y, terms = kqmm.qmm(torch.from_numpy(xq), wt, torch.from_numpy(xs),
                        return_terms=True)
    g = wt.scale.shape[0]
    want_dots = np.einsum("mgk,gkn->gmn", xq.astype(np.int64).reshape(m, g, -1),
                          np.asarray(wj.unpack()).astype(np.int64).reshape(g, -1, n))
    # the folded terms: exact dots, one fp32 rounding of the scale product
    np.testing.assert_array_equal(
        terms.numpy(),
        want_dots.astype(np.float32) * wt.scale.reshape(g, 1, n).numpy())
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.qmm(jnp.asarray(xq), wj,
                                                              jnp.asarray(xs))),
                               rtol=1e-5, atol=1e-6)
    yp = qmm_pallas(jnp.asarray(xq), wj.data, jnp.asarray(xs),
                    wj.scale.reshape(-1, n), bits=bits, k=k, interpret=True)
    # the Pallas kernel folds groups one by one, the oracle sums them: the
    # fold order differs, so cancellation is covered by 1e-5 * max|y|
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=1e-5,
                               atol=1e-5 * float(np.abs(yp).max()))
    np.testing.assert_allclose(
        ops.qmm(torch.from_numpy(xq), wt, torch.from_numpy(xs)).numpy(),
        y.numpy(), rtol=0, atol=0)


def test_int8_products_do_not_wrap():
    # torch's CPU int8 @ int8 wraps; the plain qmm must widen first
    xq = torch.full((1, 128), 127, dtype=torch.int8)
    wt = tq.quantize(torch.ones((128, 2)), 8)
    d = tref.qmm_group_dots(xq, wt)
    assert int(d[0, 0, 0]) == 127 * 127 * 128


def test_qmm_validation():
    wt = tq.quantize(torch.ones((64, 8)), 8)
    with pytest.raises(ValueError):
        ops.qmm(torch.zeros((2, 32), dtype=torch.int8), wt, torch.ones(2))
    big = tq.quantize(torch.ones((140000, 1)), 8)     # group dot can wrap
    with pytest.raises(ValueError, match="overflow int32"):
        ops.qmm(torch.zeros((1, 140000), dtype=torch.int8), big, torch.ones(1))


def _pages(rng, bits, p, page, kvh, dh):
    if bits >= 16:
        k = rng.normal(size=(p, page, kvh, dh)).astype(np.float32)
        v = rng.normal(size=(p, page, kvh, dh)).astype(np.float32)
        return k, v, None, None
    qm = int(jq.qmax_for_bits(bits))
    qk = rng.integers(-qm, qm + 1, size=(p, page, kvh, dh)).astype(np.int8)
    qv = rng.integers(-qm, qm + 1, size=(p, page, kvh, dh)).astype(np.int8)
    k = np.asarray(jq.pack(jnp.asarray(qk), bits, axis=-1))
    v = np.asarray(jq.pack(jnp.asarray(qv), bits, axis=-1))
    ks = (rng.random((p, kvh)) * 0.1 + 0.01).astype(np.float32)
    vs = (rng.random((p, kvh)) * 0.1 + 0.01).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("bits", (16, 8, 6, 4, 3))
def test_paged_attention(bits):
    rng = np.random.default_rng(bits)
    b, kvh, g, dh, page, np_ = 3, 2, 2, 16, 4, 5
    p = 16
    k, v, ks, vs = _pages(rng, bits, p, page, kvh, dh)
    q = rng.normal(size=(b, 1, kvh * g, dh)).astype(np.float32)
    table = rng.permutation(p)[:b * np_].reshape(b, np_).astype(np.int32)
    table[0, 2:] = p            # unmapped tail
    table[1, 4] = p + 7         # out-of-range id, clipped then masked
    pos = np.array([5, 13, 19], np.int32)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (q, k, v, table, pos, ks, vs)]
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (q, k, v, table, pos, ks, vs)]
    want = np.asarray(jref.paged_attention(*jargs, bits=bits))
    got = ops.paged_attention(*targs, bits=bits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    pal = paged_attention_pallas(jargs[0].reshape(b, kvh, g, dh), *jargs[1:4],
                                 jargs[4] + 1, jargs[5], jargs[6], bits=bits,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=1e-5, rtol=0)


def test_kernels_need_cpu_or_cuda():
    with pytest.raises(ValueError):
        kef.ef_sqnorm(torch.zeros((2, 3), device="meta"))
