"""The port's Hessian traces (``repro_torch.core.hessian``) against
repro.core.hessian: Hessian-vector products on one numpy probe (the MLP
of the reference's tests and the internlm2_1_8b smoke transformer,
whose fp forward must be differentiable twice), exact per-block traces,
and Hutchinson's estimate against the exact traces, deterministic under
one seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.hessian import (exact_block_traces as j_exact, hvp as j_hvp,
                                rademacher_like as j_rademacher)
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.models.transformer import init_params as j_init, loss_fn as j_loss
from repro.utils.pytree import named_leaves as j_named_leaves
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import (exact_block_traces, hutchinson_block_traces, hvp)
from repro_torch.core.hessian import rademacher_like
from repro_torch.models import loss_fn
from repro_torch.utils.pytree import named_leaves

from test_torch_core import _mlp
from _torch_threads import _one_thread  # noqa: F401


def _hv_close(got, want, rtol):
    tl, jl = named_leaves(got), j_named_leaves(want)
    assert [n for n, _ in tl] == [n for n, _ in jl]
    for (name, t), (_, j) in zip(tl, jl):
        j = np.asarray(j)
        scale = float(np.abs(j).max()) or 1.0
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("probe", ["normal", "reference_rademacher"])
def test_hvp_matches_reference_mlp(probe):
    jp, jb, jl, tp, tb, tl, _ = _mlp()
    if probe == "normal":
        rng = np.random.default_rng(1)
        vec = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
    else:
        vec = jax.tree.map(np.asarray, j_rademacher(jp, jax.random.key(3)))
    want = j_hvp(jl, jp, jb, jax.tree.map(jnp.asarray, vec))
    got = hvp(tl, tp, tb, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), vec))
    _hv_close(got, want, 1e-5)


def test_hvp_matches_reference_transformer():
    """The smoke transformer's loss differentiated twice: reverse over
    reverse in the port, forward over reverse in the reference."""
    jcfg = dataclasses.replace(j_smoke("internlm2_1_8b"), scan_layers=False)
    cfg = smoke_config("internlm2_1_8b")
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    b = next(lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                       global_batch=2, seed=0)))
    vec = jax.tree.map(np.asarray, j_rademacher(jp, jax.random.key(1)))
    want = jax.jit(lambda v: j_hvp(lambda p, z: j_loss(p, z, jcfg), jp,
                                   {k: jnp.asarray(x) for k, x in b.items()}, v)
                   )(jax.tree.map(jnp.asarray, vec))
    got = hvp(lambda p, z: loss_fn(p, z, cfg), tp,
              {k: torch.from_numpy(x) for k, x in b.items()},
              params_from_numpy(vec, device="cpu"))
    _hv_close(got, want, 1e-4)


def test_exact_block_traces_match_reference():
    jp, jb, jl, tp, tb, tl, _ = _mlp()
    got = exact_block_traces(tl, tp, tb)
    want = j_exact(jl, jp, jb)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def test_hutchinson_within_monte_carlo_error_and_deterministic():
    _, _, _, tp, tb, tl, _ = _mlp()
    exact = exact_block_traces(tl, tp, tb)
    gen = torch.Generator().manual_seed(0)
    means, samples = hutchinson_block_traces(tl, tp, tb, gen, iters=200)
    assert list(means) == list(exact)
    for k, v in exact.items():
        s = samples[k]
        assert s.shape == (200,) and np.isfinite(s).all()
        sem = s.std(ddof=1) / np.sqrt(len(s))
        assert abs(means[k] - v) <= 4 * sem + 1e-6, (k, means[k], v, sem)
    again = hutchinson_block_traces(tl, tp, tb, torch.Generator().manual_seed(0),
                                    iters=200)
    assert again[0] == means
    for k in samples:
        np.testing.assert_array_equal(again[1][k], samples[k])


def test_rademacher_probes_are_signs_of_one_seed():
    _, _, _, tp, _, _, _ = _mlp()
    a = rademacher_like(tp, torch.Generator().manual_seed(5))
    b = rademacher_like(tp, torch.Generator().manual_seed(5))
    for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        assert x.dtype == torch.float32 and torch.equal(x, y), name
        assert set(x.unique().tolist()) <= {-1.0, 1.0}
