"""The port's numpy-side FIT tooling against the reference on the same
inputs: the baseline heuristics (``core.heuristics``), the
rank-correlation protocol (``core.rankcorr``), the noise helpers
(``quant.noise``), the pytree helpers (``utils.pytree``) and the int4
pack aliases (``kernels.ref``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heuristics as jh
from repro.core import rankcorr as jrc
from repro.core.fit import SensitivityReport as JReport
from repro.kernels import ref as jref
from repro.quant import noise as jnoise
from repro.quant.policy import BitConfig as JBitConfig
from repro.utils import pytree as jpt
from repro_torch.core import heuristics as th
from repro_torch.core import rankcorr as trc
from repro_torch.core.fit import SensitivityReport
from repro_torch.kernels import ref as tref
from repro_torch.quant import noise as tnoise
from repro_torch.quant.policy import BitConfig
from repro_torch.utils import get_logger, pytree as tpt
from _torch_threads import _one_thread  # noqa: F401


def _report(seed=0):
    """A synthetic report (four weight blocks, two activation sites, one of
    them without a range) as JSON both packages read."""
    rng = np.random.default_rng(seed)
    w = {f"layers/{i}/{b}": float(rng.uniform(0.1, 5.0))
         for i in range(2) for b in ("wq", "w_up")}
    a = {"layers/0/k": 0.7, "layers/1/v": 1.9}
    wr = {k: (-float(rng.uniform(0.1, 2)), float(rng.uniform(0.1, 2))) for k in w}
    wr["layers/1/wq"] = (0.0, 0.0)            # a zero range
    ar = {"layers/0/k": (-3.0, 2.5)}
    sizes = {k: int(rng.integers(16, 4096)) for k in w}
    return SensitivityReport(w, a, wr, ar, sizes).to_json()


def _configs(rep, n, seed=1):
    rng = np.random.default_rng(seed)
    names = list(rep.weight_traces)
    return [({k: int(rng.choice([2, 3, 4, 8, 16])) for k in names},
             {"layers/0/k": int(rng.choice([4, 8])),
              "layers/1/v": int(rng.choice([4, 8]))}) for _ in range(n)]


def test_heuristics_equal_reference():
    js = _report()
    jr, tr = JReport.from_json(js), SensitivityReport.from_json(js)
    gammas = {"layers/0/wq": 0.5, "layers/1/w_up": 2.0, "layers/0/w_up": 0.0}
    for wb, ab in _configs(tr, 12):
        jc, tc = JBitConfig(wb, ab), BitConfig(wb, ab)
        for name in th.ALL_METRICS:
            assert th.ALL_METRICS[name](tr, tc) == jh.ALL_METRICS[name](jr, jc), name
        assert th.bn_metric(tr, tc, gammas) == jh.bn_metric(jr, jc, gammas)
        assert th.fit_w(tr, tc) == jh.fit_w(jr, jc)
        assert th.fit_a(tr, tc) == jh.fit_a(jr, jc)
    assert set(th.ALL_METRICS) == set(jh.ALL_METRICS)
    levels = (2, 3, 4, 8)
    rng = np.random.default_rng(2)
    W = rng.integers(0, 5, (20, 4))
    A = rng.integers(0, 5, (20, 1))
    for metric in ("FIT", "FIT_W", "FIT_A", "QR", "QR_W", "QR_A", "Noise", "BN"):
        g = gammas if metric == "BN" else None
        tp = th.metric_packed(tr, metric, levels, g)
        jp = jh.metric_packed(jr, metric, levels, g)
        np.testing.assert_array_equal(tp.weight_table, jp.weight_table)
        np.testing.assert_array_equal(tp.act_table, jp.act_table)
        np.testing.assert_array_equal(
            th.metric_values_batch(tr, metric, levels, W, A, g),
            jh.metric_values_batch(jr, metric, levels, W, A, g))
    with pytest.raises(ValueError):
        th.metric_packed(tr, "BN", levels)
    with pytest.raises(KeyError):
        th.metric_packed(tr, "HAWQ", levels)


@pytest.mark.parametrize("ties", [False, True])
def test_rankcorr_equal_reference(ties):
    rng = np.random.default_rng(4)
    x = rng.normal(size=40)
    y = 0.6 * x + rng.normal(size=40)
    if ties:
        x, y = np.round(x), np.round(y * 2) / 2
    for fn in ("spearman", "pearson", "kendall"):
        assert getattr(trc, fn)(x, y) == getattr(jrc, fn)(x, y), fn
    assert trc.metric_accuracy_correlation(x, y) == \
        jrc.metric_accuracy_correlation(x, y)
    assert trc.pearson([1.0, 1.0], [2.0, 3.0]) == 0.0
    assert trc.kendall([1.0], [2.0]) == 0.0


def test_noise_helpers_equal_reference():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "b": {"c": rng.uniform(0.5, 2.0, (32,)).astype(np.float32)},
            "d": rng.normal(size=(4,)).astype(np.float32)}
    cfg = {"a": 4, "b/c": 8, "d": 16}
    want = jnoise.expected_noise_tree(jax.tree.map(jnp.asarray, tree), cfg)
    got = tnoise.expected_noise_tree(jax.tree.map(torch.from_numpy, tree), cfg)
    assert got == want
    x = rng.normal(size=(64,)).astype(np.float32)
    fq = np.round(x * 8) / 8
    np.testing.assert_allclose(
        float(tnoise.empirical_noise_power(torch.from_numpy(x), torch.from_numpy(fq))),
        float(jnoise.empirical_noise_power(jnp.asarray(x), jnp.asarray(fq))),
        rtol=1e-6)


def test_pytree_helpers_equal_reference():
    rng = np.random.default_rng(6)
    tree = {"z": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "a": [rng.integers(0, 9, (5,)).astype(np.int32),
                  rng.normal(size=(2,)).astype(np.float16)],
            "m": rng.normal(size=(6,)).astype(np.float32)}
    tt = {"z": {"w": torch.from_numpy(tree["z"]["w"])},
          "a": [torch.from_numpy(x) for x in tree["a"]],
          "m": torch.from_numpy(tree["m"])}
    jt = jax.tree.map(jnp.asarray, tree)
    assert tpt.tree_size(tt) == jpt.tree_size(jt) == 25
    assert tpt.tree_bytes(tt) == jpt.tree_bytes(jt)
    assert tpt.block_paths(tt) == jpt.block_paths(jt)
    for path in jpt.block_paths(jt):
        np.testing.assert_array_equal(tpt.get_by_path(tt, path).numpy(),
                                      np.asarray(jpt.get_by_path(jt, path)))
    new = tpt.set_by_path(tt, "a/1", torch.zeros(2))
    assert torch.equal(new["a"][1], torch.zeros(2)) and new["a"][1] is not tt["a"][1]
    assert tt["a"][1].dtype == torch.float16 and new["z"] is tt["z"]
    assert tpt.block_paths(new) == tpt.block_paths(tt)
    with pytest.raises(TypeError):
        tpt.set_by_path({"x": torch.zeros(1)}, "x/0", 1)
    assert get_logger("repro_torch.test").name == "repro_torch.test"


@pytest.mark.parametrize("shape", [(6,), (3, 8), (2, 4, 16)])
def test_pack_int4_round_trip_equal_reference(shape):
    q = np.random.default_rng(7).integers(-8, 8, shape).astype(np.int8)
    packed = tref.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape[-1] == shape[-1] // 2
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jref.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tref.unpack_int4(packed).numpy(), q)
