"""The port's EF traces against repro.core.fisher: pytree batches (a
tuple ``(X, Y)``, as the reference's own tests pass), the per-leaf
reduction against per-sample ``torch.autograd.grad`` plus the plain
``ef_sqnorm``, the data-parallel mode on CPU shards (a ``TPMesh`` and a
1-D data ``Mesh``), and ``fisher_trace_exact``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (build_report as j_build, ef_trace_weights as j_ef,
                        fisher_trace_exact as j_exact)
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro_torch.configs import smoke_config
from repro_torch.core import (build_report, ef_trace_weights,
                              ef_trace_weights_streaming, fisher_trace_exact)
from repro_torch.core.fisher import per_sample_sqnorms
from repro_torch.kernels import ref
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import init_params, loss_fn
from repro_torch.utils.pytree import map_with_names, named_leaves
from _torch_threads import _one_thread  # noqa: F401


def _mlp(n=32, seed=0):
    """The reference tests' MLP (``tests/test_fisher.py``) in both
    packages, on one numpy draw: params, a tuple batch, the loss."""
    rng = np.random.default_rng(seed)
    p = {"l1": {"w": rng.normal(0, .5, (8, 16)).astype(np.float32),
                "b": np.zeros(16, np.float32)},
         "l2": {"w": rng.normal(0, .5, (16, 4)).astype(np.float32),
                "b": np.zeros(4, np.float32)}}
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)

    def j_loss(p, batch):
        x, y = batch
        h = jnp.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
        lp = jax.nn.log_softmax(h @ p["l2"]["w"] + p["l2"]["b"])
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], 1))

    def t_loss(p, batch):
        x, y = batch
        h = torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
        lp = torch.log_softmax(h @ p["l2"]["w"] + p["l2"]["b"], dim=-1)
        return -torch.mean(torch.gather(lp, 1, y.long()[:, None]))

    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    return (jp, (jnp.asarray(x), jnp.asarray(y)), j_loss,
            tp, (torch.from_numpy(x), torch.from_numpy(y)), t_loss, (x, y))


def _close(got, want, rtol):
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("microbatch", [None, 8])
def test_tuple_batch_matches_reference(microbatch):
    """R3: ``ef_trace_weights`` and ``build_report`` take any pytree batch
    (the parent raised AttributeError on a tuple)."""
    jp, jb, jl, tp, tb, tl, npb = _mlp()
    _close(ef_trace_weights(tl, tp, tb, microbatch),
           j_ef(jl, jp, jb, microbatch), 1e-5)
    jr = j_build(jl, None, None, None, jp, [jb], microbatch=microbatch,
                 tolerance=None, max_batches=1)
    # numpy leaves, moved to the device leaf by leaf
    tr = build_report(tl, None, None, None, tp, [npb], microbatch=microbatch,
                      tolerance=None, max_batches=1, device="cpu")
    _close(tr.weight_traces, jr.weight_traces, 1e-5)
    assert tr.weight_ranges == jr.weight_ranges
    assert tr.param_sizes == jr.param_sizes


def test_nested_and_named_tuple_batches():
    from typing import NamedTuple

    class Batch(NamedTuple):
        x: torch.Tensor
        y: torch.Tensor

    _, _, _, tp, (x, y), tl, _ = _mlp(8)
    want = ef_trace_weights(tl, tp, (x, y))
    assert ef_trace_weights(tl, tp, Batch(x, y)) == want
    assert ef_trace_weights(lambda p, b: tl(p, (b["in"][0], b["y"])), tp,
                            {"in": [x], "y": y}) == want


@pytest.fixture(scope="module")
def smoke():
    cfg = smoke_config("internlm2_1_8b")
    params = init_params(cfg, seed=0, device="cpu")
    b = next(lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                       global_batch=4, seed=0)))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    return cfg, params, batch


def test_per_leaf_reduction_equals_per_sample_grads(smoke):
    """Each block's gradient reduced as autograd accumulates it equals,
    bit for bit, the whole per-sample gradient of ``torch.autograd.grad``
    reduced by the plain ``ef_sqnorm`` as one (1, N) row."""
    cfg, params, batch = smoke
    got = per_sample_sqnorms(lambda p, b: loss_fn(p, b, cfg), params, batch)
    names = [n for n, _ in named_leaves(params)]
    assert list(got) == names
    leaves = {n: leaf.detach().requires_grad_(True)
              for n, leaf in named_leaves(params)}
    p = map_with_names(lambda n, _: leaves[n], params)
    for i in range(4):
        sample = {k: v[i:i + 1] for k, v in batch.items()}
        grads = torch.autograd.grad(loss_fn(p, sample, cfg), list(leaves.values()))
        for name, g in zip(names, grads):
            want = ref.ef_sqnorm(g.reshape(1, -1))
            assert torch.equal(got[name][i:i + 1], want), name
    traces = ef_trace_weights(lambda p, b: loss_fn(p, b, cfg), params, batch, 2)
    assert traces == {k: float(torch.mean(v)) for k, v in got.items()}


def test_per_leaf_reduction_one_row_a_block(monkeypatch):
    """``ef_sqnorm`` gets one sample's one block a call, as a (1, N) row,
    while that block's gradient is the only one alive."""
    from repro_torch.core import fisher
    _, _, _, tp, tb, tl, _ = _mlp(4)
    made, seen = [], []
    real_leaves, real_sqnorm = fisher._grad_leaves, fisher.kops.ef_sqnorm

    def leaves_spy(params):
        out = real_leaves(params)
        made.append(out[0])
        return out

    def sqnorm_spy(g):
        alive = [n for n, leaf in made[-1].items() if leaf.grad is not None]
        seen.append((tuple(g.shape), len(alive)))
        return real_sqnorm(g)

    monkeypatch.setattr(fisher, "_grad_leaves", leaves_spy)
    monkeypatch.setattr(fisher.kops, "ef_sqnorm", sqnorm_spy)
    fisher.per_sample_sqnorms(tl, tp, tb)
    assert len(seen) == 4 * 4
    assert {shape for shape, _ in seen} == {(1, 4), (1, 16), (1, 64), (1, 128)}
    assert {alive for _, alive in seen} == {1}


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_matches_no_mesh(shards):
    """Data-parallel shards on the CPU agree with no mesh (rtol 1e-5, as
    the reference's own sharded test holds), microbatched too, and through
    ``build_report``; a batch the shards do not divide is refused."""
    _, _, _, tp, tb, tl, npb = _mlp(64)
    mesh = TPMesh(["cpu"] * shards)
    want = ef_trace_weights(tl, tp, tb)
    _close(ef_trace_weights(tl, tp, tb, mesh=mesh), want, 1e-5)
    _close(ef_trace_weights(tl, tp, tb, microbatch=4, mesh=mesh), want, 1e-5)
    rep = build_report(tl, None, None, None, tp, [npb], tolerance=None,
                       max_batches=1, mesh=mesh, device="cpu")
    _close(rep.weight_traces, want, 1e-5)
    streamed, used = ef_trace_weights_streaming(tl, tp, [tb, tb], mesh=mesh)
    assert used == 2
    _close(streamed, want, 1e-5)
    with pytest.raises(ValueError, match="divisible"):
        ef_trace_weights(tl, tp, (tb[0][:6], tb[1][:6]), mesh=TPMesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="microbatch"):
        ef_trace_weights(tl, tp, tb, microbatch=5, mesh=mesh)
    _close(ef_trace_weights(tl, tp, tb, mesh=mesh, mesh_axis="tp"), want, 1e-5)
    with pytest.raises(ValueError, match="mesh_axis"):
        ef_trace_weights(tl, tp, tb, mesh=mesh, mesh_axis="data")


def test_data_mesh_matches_reference():
    """``ef_trace_weights`` on a 1-D data mesh of 8 CPU shards
    (``make_mesh((8,), ("data",))``, the reference's sharded test) equals
    the reference's single-device trace at rtol 1e-5, microbatched within
    each shard too, and through ``build_report``; ``mesh_axis`` must name
    the mesh's axis, and a 2-D mesh is refused."""
    from repro_torch.launch.mesh import make_mesh
    jp, jb, jl, tp, tb, tl, npb = _mlp(64)
    want = {k: float(v) for k, v in j_ef(jl, jp, jb).items()}
    mesh = make_mesh((8,), ("data",), device="cpu")
    _close(ef_trace_weights(tl, tp, tb, mesh=mesh), want, 1e-5)
    _close(ef_trace_weights(tl, tp, tb, microbatch=4, mesh=mesh,
                            mesh_axis="data"), want, 1e-5)
    rep = build_report(tl, None, None, None, tp, [npb], tolerance=None,
                       max_batches=1, mesh=mesh, device="cpu")
    _close(rep.weight_traces, want, 1e-5)
    with pytest.raises(ValueError, match="mesh_axis"):
        ef_trace_weights(tl, tp, tb, mesh=mesh, mesh_axis="model")
    with pytest.raises(ValueError, match="1-D mesh"):
        ef_trace_weights(tl, tp, tb, mesh=make_mesh((2, 4), ("data", "model"),
                                                    device="cpu"))


def test_fisher_trace_exact_matches_reference():
    jp, jb, jl, tp, tb, tl, _ = _mlp()
    exact = fisher_trace_exact(tl, tp, tb)
    _close(exact, j_exact(jl, jp, jb), 1e-5)
    _close(ef_trace_weights(tl, tp, tb), exact, 1e-5)
