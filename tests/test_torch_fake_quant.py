"""The port's fake quantization and calibration observers against the
reference on the CPU: the plain ``fake_quant`` (the CPU route of both
kernels) bit-equal to the JAX oracle at every dtype, width, grid and
channel axis; against the Pallas kernels in interpret mode at the
reference's own kernel-test shapes and tolerances; the STE gradient,
``clip_stats`` and the observers' states equal to the reference's.
Inputs come from numpy with a seed and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fake_quant import (
    clip_stats as j_clip_stats, fake_quant_pallas,
    fake_quant_per_channel_pallas)
from repro.quant import calibration as jcal
from repro.quant.fake_quant import fake_quant as j_fake_quant
from repro.quant.quantizer import QuantSpec as JSpec
from repro_torch.kernels import ops, ref
from repro_torch.quant import (
    EmaObserver, MinMaxObserver, QuantSpec, fake_quant)
from repro_torch.quant.calibration import init_range_state
from _torch_threads import _one_thread  # noqa: F401


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _grid(rng, shape, bits, symmetric, axis):
    """Scale and zero point (fp32) broadcast against ``shape``: one value
    (axis None) or one per channel along ``axis``; symmetric grids put the
    zero point at 2^(b-1) - 1 and end at 2^b - 2."""
    levels = 2.0 ** bits - (2.0 if symmetric else 1.0)
    n = 1 if axis is None else shape[axis]
    bshape = [1] * len(shape)
    if axis is not None:
        bshape[axis] = n
    scale = rng.uniform(0.01, 0.1, n).astype(np.float32).reshape(bshape)
    if symmetric:
        zp = np.full(bshape, 2.0 ** (bits - 1) - 1, np.float32)
    else:
        zp = rng.integers(0, int(levels) + 1, n).astype(np.float32).reshape(bshape)
    return scale, zp, levels


@pytest.mark.parametrize("axis", [None, -1, 0])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("bits", [8, 4, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_fake_quant_bit_equal_to_jax_oracle(dtype, bits, symmetric, axis):
    """Per tensor and per channel (last axis, axis 0; a ragged and a
    square shape): the plain version through ``ops.fake_quant`` returns
    exactly the oracle's values, in the input dtype."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(bits * 10 + symmetric)
    for shape in ((37, 40), (32, 32)):
        x = (rng.normal(size=shape) * 1.5).astype(np.float32)
        ax = None if axis is None else axis % len(shape)
        scale, zp, levels = _grid(rng, shape, bits, symmetric, ax)
        want = jref.fake_quant(jnp.asarray(x, jd), jnp.asarray(scale),
                               jnp.asarray(zp), bits, levels=levels)
        got = ops.fake_quant(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                             torch.from_numpy(zp), bits, levels=levels)
        assert got.dtype == td and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.float().numpy(), _np32(want))


@pytest.mark.parametrize("shape", [(16, 16), (300, 257), (1, 5), (1024, 64), (7,)])
def test_fake_quant_matches_pallas_interpret(shape):
    """``tests/test_kernels.py``'s per-tensor sweep (fp32/fp16, 8/4/3 bits,
    scale 0.07, zero point 3) against ``fake_quant_pallas`` in interpret
    mode, at its tolerance (rtol = atol = 1e-3)."""
    rng = np.random.default_rng(0)
    for dt in (np.float32, np.float16):
        x = rng.normal(size=shape).astype(dt)
        for bits in (8, 4, 3):
            want = fake_quant_pallas(jnp.asarray(x), jnp.float32(0.07),
                                     jnp.float32(3.0), bits, interpret=True)
            got = ops.fake_quant(torch.from_numpy(x), 0.07, 3.0, bits)
            np.testing.assert_allclose(got.float().numpy(), _np32(want),
                                       rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("rows,cols", [(33, 64), (8, 128), (100, 30)])
def test_fake_quant_per_channel_matches_pallas_interpret(rows, cols):
    """``tests/test_kernels.py``'s per-channel cases against
    ``fake_quant_per_channel_pallas`` in interpret mode, at its tolerance
    (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(0)
    for bits in (8, 4):
        x = rng.normal(size=(rows, cols)).astype(np.float32)
        sc = rng.uniform(0.01, 0.1, (1, cols)).astype(np.float32)
        zc = rng.integers(0, 2 ** bits - 1, (1, cols)).astype(np.float32)
        want = fake_quant_per_channel_pallas(
            jnp.asarray(x), jnp.asarray(sc).reshape(cols),
            jnp.asarray(zc).reshape(cols), bits, interpret=True)
        got = ops.fake_quant(torch.from_numpy(x), torch.from_numpy(sc),
                             torch.from_numpy(zc), bits)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _divide_vs_reciprocal_case():
    """An fp32 element inside a 4-bit grid (scale 0.1, zero point 8) whose
    grid index x/s + zp rounds one way and x·(1/s) + zp the other: a .5
    boundary within a few ulps."""
    s = np.float32(0.1)
    inv = np.float32(1.0) / s
    mid = (np.arange(-7, 7, dtype=np.float32) + np.float32(0.5)) * s
    for k in range(-8, 9):
        x = mid + np.float32(k) * np.spacing(mid)
        hit = np.nonzero(np.round(x / s + np.float32(8))
                         != np.round(x * inv + np.float32(8)))[0]
        if hit.size:
            return x[hit[:1]].reshape(1, 1), s
    raise AssertionError("no boundary element found")


def test_reference_per_channel_routes_differ_port_follows_oracle():
    """Reference properties (ROADMAP § C): the Pallas per-channel kernel
    divides by the scale while the per-tensor kernel and the oracle
    multiply by the reciprocal, so an element at a .5 boundary lands one
    grid step apart; and the reference's per-channel dispatch
    (``REPRO_KERNELS=interpret``) reshapes the scale to the LAST axis, so
    ``channel_axis=0`` on a non-square weight fails. The port multiplies
    by the reciprocal on both granularities and takes any axis."""
    x, s = _divide_vs_reciprocal_case()
    x2 = np.repeat(x, 2, axis=1)
    sc, zp = np.full(2, s, np.float32), np.full(2, 8.0, np.float32)
    pallas = np.asarray(fake_quant_per_channel_pallas(
        jnp.asarray(x2), jnp.asarray(sc), jnp.asarray(zp), 4, interpret=True))
    oracle = np.asarray(jref.fake_quant(jnp.asarray(x2), jnp.asarray(sc),
                                        jnp.asarray(zp), 4))
    assert not np.array_equal(pallas, oracle)
    got = ops.fake_quant(torch.from_numpy(x2), torch.from_numpy(sc),
                         torch.from_numpy(zp), 4)
    np.testing.assert_array_equal(got.numpy(), oracle)

    w = np.random.default_rng(1).normal(size=(24, 40)).astype(np.float32)
    spec0 = JSpec(bits=8, symmetric=True, channel_axis=0)
    with pytest.raises(Exception):
        jax.block_until_ready(j_fake_quant(jnp.asarray(w), spec0))   # interpret route
    t = fake_quant(torch.from_numpy(w), QuantSpec(bits=8, symmetric=True,
                                                  channel_axis=0))
    assert tuple(t.shape) == w.shape


@pytest.mark.parametrize("spec", [
    dict(bits=4), dict(bits=8, symmetric=True), dict(bits=3, channel_axis=-1),
    dict(bits=8, symmetric=True, channel_axis=0), dict(bits=4, channel_axis=0)])
def test_quant_fake_quant_forward_and_ste_gradient(monkeypatch, spec):
    """``quant.fake_quant`` (ranges from the data, per-channel reshape on
    any axis, the spec's levels) equals ``repro.quant.fake_quant`` on the
    oracle route on a square and a non-square weight, and its gradient is
    ``jax.grad``'s: the identity."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    rng = np.random.default_rng(3)
    for shape in ((24, 40), (32, 32)):
        x = rng.normal(size=shape).astype(np.float32)
        g = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(j_fake_quant(jnp.asarray(x), JSpec(**spec)))
        jgrad = np.asarray(jax.grad(lambda a: jnp.sum(
            j_fake_quant(a, JSpec(**spec)) * jnp.asarray(g)))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fake_quant(xt, QuantSpec(**spec))
        np.testing.assert_array_equal(y.detach().numpy(), want)
        (y * torch.from_numpy(g)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), jgrad)
        np.testing.assert_array_equal(xt.grad.numpy(), g)


def test_bits_16_returns_input():
    x = torch.randn(4, 5)
    assert fake_quant(x, QuantSpec(bits=16)) is x
    assert fake_quant(x, QuantSpec(bits=32, channel_axis=0)) is x


@pytest.mark.parametrize("levels", [None, 14.0])
def test_clip_stats_matches_reference(levels):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(50, 30)) * 2).astype(np.float32)
    sc = rng.uniform(0.05, 0.2, (1, 30)).astype(np.float32)
    zp = rng.integers(0, 15, (1, 30)).astype(np.float32)
    jc, jt = j_clip_stats(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(zp), 4,
                          levels)
    tc, tt = ref.clip_stats(torch.from_numpy(x), torch.from_numpy(sc),
                            torch.from_numpy(zp), 4, levels)
    assert float(tc) == float(jc) > 0 and float(tt) == float(jt) == x.size


@pytest.mark.parametrize("observer", ["minmax", "ema"])
def test_observers_match_reference(observer):
    """A sequence of batches (mixed signs, an all-positive one, bf16 and
    fp32) through both observers: the states equal the reference's."""
    rng = np.random.default_rng(11)
    batches = [rng.normal(size=(8, 16)) * 3, np.abs(rng.normal(size=(4, 16))),
               rng.normal(size=(2, 16)) - 5.0, rng.normal(size=(8, 16)) * 0.1]
    jobs = jcal.MinMaxObserver() if observer == "minmax" else jcal.EmaObserver(0.9)
    tobs = MinMaxObserver() if observer == "minmax" else EmaObserver(0.9)
    js, ts = jcal.init_range_state(), init_range_state(device="cpu")
    for i, b in enumerate(batches):
        jd, td = (DTYPES["bfloat16"] if i % 2 else DTYPES["float32"])
        b = b.astype(np.float32)
        prev = ts
        js = jobs.update(js, jnp.asarray(b, jd))
        ts = tobs.update(ts, torch.from_numpy(b).to(td))
        for a, t in ((js.lo, ts.lo), (js.hi, ts.hi)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        assert bool(ts.initialized) and bool(js.initialized)
        assert prev is not ts and not bool(init_range_state("cpu").initialized)
