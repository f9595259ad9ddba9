"""The (data, model) mesh of the port against the reference on the CPU,
in process: the sharding specs of every smoke config (the reference's
functions read only ``mesh.shape``, so its side takes an
``AbstractMesh``), the mesh's collectives, the collective ledger, the
partition rules, the compressed all-reduce bit for bit against the
reference's under ``jax.vmap``, the GPipe pipeline against the
reference's sequential run, and the refusals. The sharded steps are in
``test_torch_distributed_steps.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as J_SHAPES
from repro.configs import ShapeSpec as JShape
from repro.configs import smoke_config as j_smoke
from repro.launch import sharding as jsh
from repro.launch.pipeline import sequential_apply as j_sequential
from repro.models import init_params as j_init
from repro.models import partition as jpart
from repro.optim import compression as jcomp
from repro.utils import hlo as jhlo
from repro.utils.pytree import named_leaves as j_named
from repro_torch.configs import ARCH_IDS, ShapeSpec, smoke_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import (
    Mesh, NamedSharding, P, ShardedTensor, make_mesh, make_production_mesh,
    small_test_mesh)
from repro_torch.launch.pipeline import pipeline_apply, sequential_apply
from repro_torch.launch.steps import (
    TrainState, abstract_params, build_train_step, gather, place)
from repro_torch.models import partition as tpart
from repro_torch.models.transformer import init_params
from repro_torch.optim import compression as tcomp
from repro_torch.optim.adamw import init_adam
from repro_torch.utils import hlo as thlo
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
MESH_SHAPES = (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))


def _norm(entry):
    """A spec entry as a plain value: a one-axis tuple is the axis."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


def _spec(s) -> tuple:
    return tuple(_norm(e) for e in tuple(s))


def _table(t) -> dict:
    return {k: _norm(v) for k, v in t.items()}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    """``make_rules``' table, ``param_pspecs``, ``opt_pspecs`` (ZeRO-1 on
    and off) and ``input_pspecs`` equal the reference's as tuples, for
    both strategies and both MoE modes, on (2,4), (16,16) and (2,16,16)
    meshes and every shape kind."""
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    tcfg = smoke_config(arch)
    jparams = j_init(jcfg, abstract=True)
    tparams = abstract_params(tcfg)
    assert [n for n, _ in j_named(jparams)] == [n for n, _ in named_leaves(tparams)]
    shapes = [JShape("t", 32, 4, "train")] + list(J_SHAPES.values())
    for mshape, axes in MESH_SHAPES:
        jm = AbstractMesh(mshape, axes)
        tm = Mesh.on_device(mshape, axes, CPU)
        for strategy in ("tp", "fsdp"):
            for moe_mode in ("ep", "tp"):
                for zero1 in (False, True):
                    jo = jsh.ShardOptions(strategy=strategy, moe_mode=moe_mode,
                                          zero1=zero1)
                    to = tsh.ShardOptions(strategy=strategy, moe_mode=moe_mode,
                                          zero1=zero1)
                    jp = jsh.param_pspecs(jparams, jcfg, jm, jo)
                    tp = tsh.param_pspecs(tparams, tcfg, tm, to)
                    want = [(n, _spec(s.spec)) for n, s in j_named(jp)]
                    got = [(n, _spec(s.spec)) for n, s in named_leaves(tp)]
                    assert got == want, (arch, mshape, strategy, moe_mode)
                    jo_sh = jsh.opt_pspecs(jp, jparams, jm, jo)
                    to_sh = tsh.opt_pspecs(tp, tparams, tm, to)
                    assert ([_spec(s.spec) for _, s in named_leaves(to_sh)]
                            == [_spec(s.spec) for _, s in j_named(jo_sh)])
                    for s in shapes:
                        ts = ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
                        jr = jsh.make_rules(jcfg, s, jm, jo)
                        tr = tsh.make_rules(tcfg, ts, tm, to)
                        assert _table(tr.table) == _table(jr.table), (s, strategy)
                        for b_ax in (None, jr.table.get("batch")):
                            ji = jsh.input_pspecs(jcfg, s, jm, batch_ax=b_ax)
                            ti = tsh.input_pspecs(tcfg, ts, tm, batch_ax=b_ax)
                            assert {k: _spec(v.spec) for k, v in ti.items()} == \
                                {k: _spec(v.spec) for k, v in ji.items()}


def test_rules_spec_and_constrain_match_reference():
    """``Rules.spec`` dedups a mesh axis within one tensor as the
    reference does; ``constrain`` raises the reference's ValueError on a
    rank mismatch under rules, returns its input as it is, and is a
    no-op outside rules."""
    table = {"batch": ("data",), "seq": "model", "heads": "model",
             "vocab": "model", "kv_heads": None}
    jr = jpart.Rules(AbstractMesh((2, 4), ("data", "model")), table)
    tr = tpart.Rules(Mesh.on_device((2, 4), ("data", "model"), CPU), table)
    for axes in (("batch", "seq", "heads", None), ("batch", "kv_heads", "vocab"),
                 (None, "heads", "seq"), ("seq", "vocab"), ("unknown", "batch")):
        assert _spec(tr.spec(axes)) == _spec(jr.spec(axes)), axes
    assert tr.sharding(("batch", "seq")).spec == P("data", "model")
    x = torch.zeros(2, 3)
    assert tpart.constrain(x, "batch") is x
    with tpart.use_rules(tr):
        assert tpart.current_rules() is tr
        assert tpart.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="2 axes for rank-3"):
            tpart.constrain(torch.zeros(1, 2, 3), "batch", None)
    assert tpart.current_rules() is None


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def _parts(mesh, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {c: torch.randn(shape, generator=g) for c in mesh.coords()}


def test_mesh_shape_and_builders():
    m = small_test_mesh(device="cpu")
    assert list(m.shape.items()) == [("data", 2), ("model", 4)]
    assert m.size == 8 and m.lead == CPU and m.origin == (0, 0)
    assert m.coords()[:3] == [(0, 0), (0, 1), (0, 2)]
    pm = make_production_mesh(multi_pod=True, device="cpu")
    assert list(pm.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert make_production_mesh(device="cpu").shape == {"data": 16, "model": 16}
    assert m.axis_index(("data", "model"), (1, 2)) == 6
    with pytest.raises(ValueError):
        Mesh([[CPU, CPU]], ("data",))


def test_collectives_fold_in_shard_order_and_record():
    """psum / pmean / pmax / all_gather / psum_scatter / ppermute and
    axis_index over one and two axes against numpy; every shard of a
    group gets the group's value; the recorder sees the origin shard's
    collectives only, with its output bytes and the group size."""
    m = Mesh.on_device((2, 4), ("data", "model"), CPU)
    parts = _parts(m, (4, 6))
    arr = {c: p.numpy() for c, p in parts.items()}
    stats = thlo.CollectiveStats()
    with m.recording(stats):
        s = m.psum(parts, "model")
        mean = m.pmean(parts, ("data", "model"))
        mx = m.pmax(parts, "data")
        ag = m.all_gather(parts, "model", dim=1)
        rs = m.psum_scatter(parts, "model", dim=0)
        pp = m.ppermute(parts, "model", [(i, (i + 1) % 4) for i in range(4)])
        rows = {c: p for c, p in parts.items() if c[0] == 1}
        m.psum(rows, "model")           # the origin is not in these groups
    for (d, k), v in s.items():
        want = arr[(d, 0)] + arr[(d, 1)] + arr[(d, 2)] + arr[(d, 3)]
        np.testing.assert_array_equal(v.numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(mx[(d, k)].numpy(),
                                      np.maximum(arr[(0, k)], arr[(1, k)]))
        np.testing.assert_array_equal(
            ag[(d, k)].numpy(), np.concatenate([arr[(d, j)] for j in range(4)], 1))
        np.testing.assert_array_equal(rs[(d, k)].numpy(), want[k:k + 1])
        np.testing.assert_array_equal(pp[(d, (k + 1) % 4)].numpy(), arr[(d, k)])
    total = sum(arr[c] for c in m.coords())
    np.testing.assert_allclose(mean[(1, 3)].numpy(), total / 8, rtol=1e-6)
    assert m.axis_index("model", (1, 3)) == 3 and m.axis_index("data", (1, 3)) == 1
    nb = 4 * 6 * 4
    assert stats.count_by_kind == {"all-reduce": 3, "all-gather": 1,
                                   "reduce-scatter": 1, "collective-permute": 1}
    assert stats.bytes_by_kind == {"all-reduce": 3 * nb, "all-gather": 4 * nb,
                                   "reduce-scatter": nb // 4,
                                   "collective-permute": nb}
    # a shard without a sender gets zeros
    half = m.ppermute(parts, "model", [(0, 1)])
    assert torch.equal(half[(0, 2)], torch.zeros(4, 6))
    with pytest.raises(ValueError):
        m.psum({(0, 0): parts[(0, 0)]}, "model")


def test_collectives_are_differentiable():
    """The gradient of a loss through all_gather / psum / ppermute is the
    transposed collective's, by autograd."""
    m = Mesh.on_device((4,), ("x",), CPU)
    g = torch.Generator().manual_seed(1)
    xs = {c: torch.randn(3, generator=g, requires_grad=True) for c in m.coords()}
    w = torch.randn(12, generator=g)
    loss = (m.all_gather(xs, "x")[(2,)] * w).sum() \
        + (m.psum(xs, "x")[(0,)] ** 2).sum() \
        + m.ppermute(xs, "x", [(0, 3)])[(3,)].sum()
    loss.backward()
    tot = sum(x.detach() for x in xs.values())
    for i, c in enumerate(m.coords()):
        want = w[3 * i:3 * (i + 1)] + 2 * tot + (1.0 if i == 0 else 0.0)
        torch.testing.assert_close(xs[c].grad, want)


def test_collective_stats_match_reference():
    """``CollectiveStats`` arithmetic (add, merge, scaled_diff, totals)
    and ``shape_bytes`` equal the reference's."""
    ops = [("all-gather", 4096, 4), ("all-reduce", 1000, 8), ("all-reduce", 7, 1),
           ("reduce-scatter", 512, 4), ("collective-permute", 300, 2),
           ("all-to-all", 96, 16)]
    j1, t1, j2, t2 = (jhlo.CollectiveStats(), thlo.CollectiveStats(),
                      jhlo.CollectiveStats(), thlo.CollectiveStats())
    for k, n, g in ops:
        j1.add(k, n, g)
        t1.add(k, n, g)
        j2.add(k, 3 * n, g, mult=2.0)
        t2.add(k, 3 * n, g, mult=2.0)
    j1.merge(j2, 0.5)
    t1.merge(t2, 0.5)
    for a, b in ((j1, t1), (j2.scaled_diff(j1, 3.0), t2.scaled_diff(t1, 3.0))):
        assert (a.bytes_by_kind, a.traffic_by_kind, a.count_by_kind) == \
            (b.bytes_by_kind, b.traffic_by_kind, b.count_by_kind)
        assert (a.total_bytes, a.total_traffic) == (b.total_bytes, b.total_traffic)
    for s in ("bf16[16,4096,4096]{2,1,0}", "(f32[8,128], u32[])", "s4[7]",
              "pred[3,3]", "f32[2,2]", "token[]"):
        for f in (False, True):
            assert thlo.shape_bytes(s, f) == jhlo.shape_bytes(s, f), s


def test_place_gather_and_sharded_tensor():
    m = Mesh.on_device((2, 2), ("data", "model"), CPU)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    st = place({"w": w}, {"w": NamedSharding(m, P("model", "data"))})["w"]
    assert isinstance(st, ShardedTensor) and st.sharding.spec == P("model", "data")
    assert torch.equal(st.parts[(1, 0)], w[:4, 4:])
    assert torch.equal(st.parts[(0, 1)], w[4:, :4])
    assert st.parts[(0, 0)].data_ptr() != w.data_ptr()
    assert torch.equal(gather({"w": st})["w"], w)
    rep = place(w, NamedSharding(m, P()))
    assert all(torch.equal(p, w) for p in rep.parts.values())
    assert len({p.data_ptr() for p in rep.parts.values()}) == 4
    with pytest.raises(ValueError, match="does not split"):
        place(torch.zeros(3, 2), NamedSharding(m, P("data")))


def test_make_mesh_on_cuda_needs_the_cards(monkeypatch):
    """On CUDA a mesh takes one card a shard and raises when the host has
    fewer; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for call in (lambda: make_mesh((2, 4), ("data", "model")),
                 lambda: small_test_mesh(),
                 lambda: make_mesh((2,), ("data",), device="cuda")):
        with pytest.raises(ValueError, match="needs .* CUDA devices .* Mesh.on_device"):
            call()
    one = make_mesh((1,), ("data",))
    assert one.lead == torch.device("cuda", 0)
    on_card = Mesh.on_device((2, 4), ("data", "model"), "cuda:0")
    assert {d.type for d in on_card.devices.flat} == {"cuda"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1,), ("data",))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compressed_psum_bit_equal_to_reference():
    """The reference's ``compressed_psum`` under ``jax.vmap`` over an
    8-way "data" axis and the port's over 8 CPU shards: equal bit for
    bit, and within 3% of the mean (the reference's own bar)."""
    x = np.random.default_rng(0).normal(0, 1, (8, 128)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda r: jcomp.compressed_psum(r, "data"),
                               axis_name="data")(jnp.asarray(x)))
    m = make_mesh((8,), ("data",), device="cpu")
    stats = thlo.CollectiveStats()
    with m.recording(stats):
        got = tcomp.compressed_psum({(i,): torch.from_numpy(x[i]) for i in range(8)},
                                    m, "data")
    for i in range(8):
        np.testing.assert_array_equal(got[(i,)].numpy(), want[i])
    mean = x.mean(0)
    np.testing.assert_allclose(want[0], mean, atol=np.abs(mean).max() * 0.03 + 1e-3)
    # the int8 payloads move, 1 byte an element, and one fp32 max
    assert stats.bytes_by_kind == {"all-reduce": 4, "all-gather": 8 * 128}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_and_ef_transform_match_reference(dtype):
    """``compress_leaf``: byte-identical int8 payloads and equal scales;
    ``ef_transform`` over three steps of a tree: equal decompressed grads
    and residuals."""
    rng = np.random.default_rng(1)
    grads = [{"a": rng.normal(size=(16, 8)).astype(np.float32),
              "b": {"c": (rng.normal(size=(33,)) * 1e-3).astype(np.float32)}}
             for _ in range(3)]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    q_j, s_j = jcomp.compress_leaf(jnp.asarray(grads[0]["a"], jd))
    q_t, s_t = tcomp.compress_leaf(torch.from_numpy(grads[0]["a"]).to(td))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert float(s_t) == float(s_j)
    jef = jcomp.init_ef(jax.tree.map(lambda a: jnp.asarray(a, jd), grads[0]))
    tef = tcomp.init_ef({"a": torch.zeros(16, 8), "b": {"c": torch.zeros(33)}})
    for g in grads:
        jg, jef = jcomp.ef_transform(jax.tree.map(lambda a: jnp.asarray(a, jd), g), jef)
        tg, tef = tcomp.ef_transform({"a": torch.from_numpy(g["a"]).to(td),
                                      "b": {"c": torch.from_numpy(g["b"]["c"]).to(td)}},
                                     tef)
        for (n, a), (_, b) in zip(named_leaves(tg), j_named(jg)):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b.astype(jnp.float32)), n)
        for (n, a), (_, b) in zip(named_leaves(tef.error), j_named(jef.error)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), n)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_matches_reference_sequential():
    """GPipe on a 4-stage "pipe" mesh (M = 6 microbatches, M + S − 1
    ticks) equals the reference's ``sequential_apply`` (rtol 1e-5), and
    its gradients equal the port's sequential gradients (rtol 1e-6)."""
    s_, m_, mb, d = 4, 6, 8, 16
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (s_, d, d)).astype(np.float32)
    b = rng.normal(0, 0.1, (s_, d)).astype(np.float32)
    x = rng.normal(size=(m_, mb, d)).astype(np.float32)
    want = np.asarray(j_sequential(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                                   {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                   jnp.asarray(x)))
    mesh = make_mesh((4,), ("pipe",), device="cpu")
    params = {"w": torch.from_numpy(w).requires_grad_(True),
              "b": torch.from_numpy(b).requires_grad_(True)}

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    xt = torch.from_numpy(x)
    stats = thlo.CollectiveStats()
    with mesh.recording(stats):
        out = pipeline_apply(layer, params, xt, mesh)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    assert stats.count_by_kind == {"collective-permute": m_ + s_ - 1}
    gp = torch.autograd.grad((out ** 2).sum(), [params["w"], params["b"]])
    seq = sequential_apply(layer, params, xt)
    gs = torch.autograd.grad((seq ** 2).sum(), [params["w"], params["b"]])
    for a, b_ in zip(gp, gs):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        pipeline_apply(layer, params, xt, make_mesh((2,), ("pipe",), device="cpu"))


# ---------------------------------------------------------------------------
# the collective ledger of one (2,4) train step
# ---------------------------------------------------------------------------

def test_train_step_collective_ledger_matches_design():
    """Every collective of one (2,4) ZeRO-1 train step of the llama3_8b
    smoke config, as the origin shard records it, worked out by hand.

    The config: D 64, 4 heads (divide 4) but 2 kv heads (do not), d_ff
    128, vocab 512, 2 layers, fp32; a row is 2 sequences × 32 = 64
    tokens. Forward, a data row, per layer: wq's output (64, 64)
    all-gathered (wk, wv replicated: whole on the lead), wo's (64, 64)
    partials psum'd, w_up's and w_gate's (64, 128) gathered, w_down's
    (64, 64) psum'd; the embedding's (2, 32, 16) slices gathered to
    (2, 32, 64); the head's (64, 512) logits gathered. Then: the loss
    pmean over "data"; each replicated leaf's gradient psum'd over
    "model" (wk, wv, ln1, ln2 a layer, final_norm); every leaf's
    gradient pmean'd over "data"; one sum of squares psum'd over
    "model"; ZeRO-1's updated slices all-gathered over "data" into the
    shard's part, for every leaf (each has a dim that splits 2 ways).
    A gather's bytes are its output's, a psum's its operand's."""
    cfg = smoke_config("llama3_8b")
    mesh = small_test_mesh(device="cpu")
    sb = build_train_step(cfg, ShapeSpec("t", 32, 4, "train"), mesh,
                          tsh.ShardOptions(zero1=True))
    p = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    stats = thlo.CollectiveStats()
    with mesh.recording(stats):
        sb.fn(TrainState(p, init_adam(p)), batch)
    f4, tok, d, ff, v, n_layers = 4, 64, 64, 128, 512, 2
    fwd_gather = n_layers * (tok * d + 2 * tok * ff) * f4 + tok * d * f4 + tok * v * f4
    fwd_psum = n_layers * 2 * tok * d * f4
    leaves = named_leaves(p)
    leaf_bytes = {n: t.numel() * f4 for n, t in leaves}
    repl = [n for n in leaf_bytes if n.split("/")[-1] in ("wk", "wv", "ln1", "ln2",
                                                         "final_norm")]
    # a shard's part: a quarter of a leaf split over "model", else whole
    part = {n: b if n in repl else b // 4 for n, b in leaf_bytes.items()}
    want_bytes = {
        "all-gather": fwd_gather + sum(part.values()),
        "all-reduce": fwd_psum + f4 + sum(leaf_bytes[n] for n in repl)
        + sum(part.values()) + f4,
    }
    want_count = {"all-gather": n_layers * 3 + 2 + len(leaves),
                  "all-reduce": n_layers * 2 + 1 + len(repl) + len(leaves) + 1}
    assert stats.bytes_by_kind == want_bytes
    assert stats.count_by_kind == want_count
