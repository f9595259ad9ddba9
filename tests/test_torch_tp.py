"""The port's tensor-parallel building blocks against the JAX package on
the CPU: the per-group products (``qmm_group_products``) bit-equal to the
JAX oracle and to ``qmm_groups_pallas`` in interpret mode, their fold
equal to the plain ``qmm``, shard invariance of the terms,
``shard_error`` / ``shard`` and the shard plan equal to the reference's,
``ShardedDequantContext`` equal to ``DequantContext`` at tp 1, 2, 4 on a
CPU mesh, and ``make_tp_mesh``'s refusals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import qtensor as jq
from repro.kernels import ref as jref
from repro.kernels.qmm import qmm_groups_pallas
from repro.serve import quantized as jquant
from repro.utils.pytree import named_leaves as jnl
from repro_torch import qtensor as tq
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models.transformer import init_params as t_init
from repro_torch.kernels import ops, qmm as kqmm, ref as tref
from repro_torch.launch.mesh import TPMesh, make_tp_mesh
from repro_torch.models.context import DequantContext, ShardedDequantContext
from repro_torch.quant.policy import BitConfig as TBitConfig
from repro_torch.serve import quantized as tquant
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401


ALL_BITS = (8, 6, 4, 3)
ARCHS = ("internlm2_1_8b", "olmoe_1b_7b", "deepseek_moe_16b")


def _rowquant(x):
    xs = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-8) / 127.0
    return np.clip(np.round(x / xs), -127, 127).astype(np.int8), xs.astype(np.float32)


def _to_jax(node):
    """A port tree (QTensors, tensors) as the reference's, same bytes."""
    if isinstance(node, dict):
        return {k: _to_jax(v) for k, v in node.items()}
    if isinstance(node, tq.QTensor):
        return jq.QTensor(jnp.asarray(node.data.numpy()),
                          jnp.asarray(node.scale.numpy()), node.bits,
                          node.shape, node.axis)
    return jnp.asarray(node.numpy())


def _case(bits, m, k, n, gs, seed=0):
    """One random (x_q, x_scale, W) as JAX and port QTensors of the same
    bytes (the two quantizers' byte identity is tested elsewhere)."""
    rng = np.random.default_rng(seed + 31 * bits + m)
    xq, xs = _rowquant(rng.normal(size=(m, k)).astype(np.float32))
    jw = jq.quantize(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)),
                     bits, group_size=gs)
    tw = tq.QTensor(torch.from_numpy(np.asarray(jw.data)),
                    torch.from_numpy(np.asarray(jw.scale)), jw.bits, jw.shape,
                    jw.axis)
    return xq, xs, jw, tw


# ---------------------------------------------------------------------------
# qmm_group_products: the plain version of qmm_groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("m,k,n,gs", [(8, 32, 16, 8), (5, 48, 33, 12)])
def test_group_products_equal_jax_oracle_and_pallas(bits, m, k, n, gs):
    """The shapes of the reference's own ``qmm_groups_pallas`` test, ragged
    N = 33 and group 12 included: bit-equal to the oracle and to the
    Pallas kernel in interpret mode, through every port entry point."""
    xq, _, jw, tw = _case(bits, m, k, n, gs)
    want = np.asarray(jref.qmm_group_products(jnp.asarray(xq), jw))
    g = jw.scale.shape[0]
    pallas = np.asarray(qmm_groups_pallas(jnp.asarray(xq), jw.data,
                                          jw.scale.reshape(g, n), bits=bits,
                                          k=k, bm=16, bn=32, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    x = torch.from_numpy(xq)
    for got in (tref.qmm_group_products(x, tw), kqmm.qmm_groups(x, tw),
                ops.qmm_group_products(x, tw)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (g, m, n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", ALL_BITS)
def test_fold_times_scale_equals_plain_qmm(bits):
    """The left fold of the terms times x_scale is the port's plain qmm,
    bit for bit, through the fold's plain version and its wrapper."""
    xq, xs, _, tw = _case(bits, 6, 64, 40, 8)
    x, s = torch.from_numpy(xq), torch.from_numpy(xs)
    terms = ops.qmm_group_products(x, tw)
    want = ops.qmm(x, tw, s)
    assert torch.equal(tref.fold_group_terms(terms, s), want)
    assert torch.equal(kqmm.qmm_groups_fold(terms, s), want)
    assert torch.equal(ops.fold_group_terms(terms, s.reshape(-1)), want)


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_group_terms_are_shard_invariant(bits, n_shards):
    """A K-shard that owns whole groups computes exactly its slice of the
    full terms; gathered in shard order they are the full terms."""
    xq, _, _, tw = _case(bits, 4, 64, 24, 8)
    x = torch.from_numpy(xq)
    full = ops.qmm_group_products(x, tw)
    kl, gl = 64 // n_shards, 8 // n_shards
    parts = tq.shard(tw, n_shards, 0)
    for i, part in enumerate(parts):
        got = ops.qmm_group_products(x[:, i * kl:(i + 1) * kl].contiguous(), part)
        assert torch.equal(got, full[i * gl:(i + 1) * gl])
    mesh = TPMesh(["cpu"] * n_shards)
    gathered = mesh.all_gather(
        [ops.qmm_group_products(x[:, i * kl:(i + 1) * kl], p)
         for i, p in enumerate(parts)], dim=0)
    assert torch.equal(gathered, full)


def test_qmm_groups_validation():
    xq, _, _, tw = _case(8, 4, 32, 16, 8)
    with pytest.raises(ValueError, match="does not match"):
        kqmm.qmm_groups(torch.from_numpy(xq)[:, :16], tw)
    with pytest.raises(ValueError, match="fp32"):
        kqmm.qmm_groups_fold(torch.zeros((2, 3, 4), dtype=torch.float64),
                             torch.ones(3))
    with pytest.raises(ValueError, match="entries"):
        kqmm.qmm_groups_fold(torch.zeros((2, 3, 4)), torch.ones(4))
    with pytest.raises(ValueError, match="unsupported device"):
        kqmm.qmm_groups(torch.from_numpy(xq).to("meta"), tw)


# ---------------------------------------------------------------------------
# shard_error / shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", ALL_BITS)
def test_shard_error_and_shard_equal_reference(bits):
    """Over K x G x n x axis (the 6-bit pack unit, a single scale group,
    groups that do not align, N that does not divide): the same verdict
    and message as the reference, and where it shards, the same bytes."""
    rng = np.random.default_rng(bits)
    n_out = 12
    checked = 0
    for k in (24, 48, 64):
        w = rng.normal(size=(k, n_out)).astype(np.float32)
        for gs in (None, 4, 8, 12, k // 2):
            if gs is not None and (k % gs or gs % tq.pack_unit(bits)):
                continue
            tw = tq.quantize(torch.from_numpy(w), bits, group_size=gs)
            jw = _to_jax(tw)
            for n in (1, 2, 3, 4, 8, 16):
                for axis in (0, 1, -1):
                    want = jq.shard_error(jw, n, axis)
                    assert tq.shard_error(tw, n, axis) == want, (k, gs, n, axis)
                    checked += 1
                    if want is not None:
                        with pytest.raises(ValueError, match="cannot shard"):
                            tq.shard(tw, n, axis)
                        continue
                    for a, b in zip(jq.shard(jw, n, axis), tq.shard(tw, n, axis)):
                        assert (b.shape, b.bits, b.axis) == (a.shape, a.bits, a.axis)
                        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
                        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
                    whole = torch.cat([p.dequantize() for p in tq.shard(tw, n, axis)],
                                      dim=axis)
                    assert torch.equal(whole, tw.dequantize())
    assert checked > 200
    single = tq.quantize(torch.ones((8, 4)), bits)
    assert "single scale group" in tq.shard_error(single, 2, 0)
    if bits == 6:
        assert "pack unit" in tq.shard_error(tq.quantize(torch.ones((8, 4)), 6, 4), 4, 0)


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    """Packed (group 8, widths cycling 8/6/4/3) and int8-backed trees of a
    smoke config, the port's and the same bytes as the reference's (the
    two quantizers' byte identity is tested with the engines)."""
    arch = request.param
    tp = t_init(t_smoke(arch), seed=0, device="cpu")
    names = [n for n, _ in named_leaves(tp)]
    bits = {n: ALL_BITS[i % 4] for i, n in enumerate(names)}
    tqp, _ = tquant.quantize_params(tp, TBitConfig(bits, {}), group_size=8,
                                    device="cpu")
    ti8, _ = tquant.quantize_params_int8(tp, 8, device="cpu")
    return arch, (_to_jax(tqp), tqp), (_to_jax(ti8), ti8)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_equals_reference(trees, n):
    _, packed, int8 = trees
    modes = set()
    for jtree, ttree in (packed, int8):
        jl = dict(jnl(jtree, is_leaf=jq.is_qtensor))
        tl = dict(named_leaves(ttree))
        assert list(jl) == list(tl)
        for name, leaf in tl.items():
            got = tquant._plan_leaf(name, leaf, n)
            assert got == jquant._plan_leaf(name, jl[name], n), (name, n)
            modes.add(got[0])
    assert {"col", "row"} <= modes


def test_shard_params_places_every_shard(trees):
    """Per-shard trees hold each planned block's shard (contiguous) and
    the full replicated leaves; per-shard bytes as the reference counts."""
    arch, (jqp, tqp), _ = trees
    mesh = make_tp_mesh(2, "cpu")
    shard_trees, shard_scales, plan = tquant.shard_params(tqp, mesh)
    assert len(shard_trees) == 2 and shard_scales == [{}, {}]
    assert plan == {tquant.qw_path(name): m for name, leaf in named_leaves(tqp)
                    for m, _ in [tquant._plan_leaf(name, leaf, 2)] if m}
    if arch != "internlm2_1_8b":
        assert "ep" in plan.values()
    for name, leaf in named_leaves(tqp):
        mode = plan.get(tquant.qw_path(name))
        for i, tree in enumerate(shard_trees):
            got = dict(named_leaves(tree))[name]
            if mode is None:
                assert got is leaf
                continue
            ax = {"col": len(leaf.shape) - 1, "row": 0, "ep": 0}[mode]
            want = tq.shard(leaf, 2, ax)[i]
            assert got.data.is_contiguous() and torch.equal(got.data, want.data)
            assert torch.equal(got.scale, want.scale) and got.shape == want.shape
    jplan = {k: v for k, v in plan.items()}
    assert tquant.sharded_storage_bytes(tqp, plan, 2) == pytest.approx(
        jquant.sharded_storage_bytes(jqp, jplan, 2))


# ---------------------------------------------------------------------------
# ShardedDequantContext == DequantContext
# ---------------------------------------------------------------------------

def _blocks(route, rng):
    """(params, scales): one col, one row and one expert stack block, and
    the tail names the plan routes them by."""
    w = {"wq": rng.normal(size=(32, 48)), "wo": rng.normal(size=(48, 32)),
         "w_up": rng.normal(size=(8, 32, 24))}
    w = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    bits = {"wq": 6, "wo": 3, "w_up": 4} if route == "packed" else {}
    if route == "packed":
        return {"wq": tq.quantize(w["wq"], 6, group_size=8),
                "wo": tq.quantize(w["wo"], 3, group_size=4),
                "w_up": tq.quantize_experts(w["w_up"], 4, group_size=4)}, {}, bits
    params, scales = {}, {}
    for name in ("wq", "wo"):
        s = w[name].abs().amax(0, keepdim=True) / 127.0
        params[name] = torch.clamp(torch.round(w[name] / s), -127, 127).to(torch.int8)
        scales[name] = s
    return params, scales, bits


@pytest.mark.parametrize("route", ["packed", "int8"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_context_equals_dequant_context(route, tp):
    rng = np.random.default_rng(tp)
    params, scales, _ = _blocks(route, rng)
    mesh = make_tp_mesh(tp, "cpu")
    trees, shard_scales, plan = tquant.shard_params(params, mesh, scales)
    want_plan = {"wq": "col", "wo": "row"}
    if route == "packed":
        want_plan["w_up"] = "ep"
    assert plan == want_plan
    plain = DequantContext(scales, torch.float32, int8_compute=True)
    sharded = ShardedDequantContext(trees, shard_scales, torch.float32, mesh,
                                    plan, int8_compute=True)
    x = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32))
    got = sharded.matmul("wq", x, trees[0]["wq"])
    assert got.shape == (2, 3, 48)
    assert torch.equal(got, plain.matmul("wq", x, params["wq"]))
    h = torch.from_numpy(rng.normal(size=(5, 48)).astype(np.float32))
    assert torch.equal(sharded.matmul("wo", h, trees[0]["wo"]),
                       plain.matmul("wo", h, params["wo"]))
    if route == "packed":
        buf = torch.from_numpy(rng.normal(size=(8, 3, 32)).astype(np.float32))
        counts = torch.tensor([3, 0, 1, 2, 3, 0, 0, 1], dtype=torch.int32)
        want = plain.expert_matmul("w_up", buf, params["w_up"], counts)
        got = sharded.expert_matmul("w_up", buf, trees[0]["w_up"], counts)
        assert torch.equal(got, want)
    # an unplanned block falls through to the parent
    assert torch.equal(sharded.matmul("w_other", x, torch.eye(32)), x)


# ---------------------------------------------------------------------------
# make_tp_mesh
# ---------------------------------------------------------------------------

def test_make_tp_mesh_and_collectives():
    mesh = make_tp_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.axis_name == "tp"
    assert mesh.devices == [torch.device("cpu")] * 3
    parts = [torch.full((2, 1), i, dtype=torch.int32) for i in range(3)]
    assert torch.equal(mesh.all_gather(parts, dim=1),
                       torch.tensor([[0, 1, 2], [0, 1, 2]], dtype=torch.int32))
    assert torch.equal(mesh.psum(parts), torch.full((2, 1), 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="at least one device"):
        TPMesh([])
    with pytest.raises(ValueError, match="tp must be"):
        make_tp_mesh(0, "cpu")


def test_make_tp_mesh_raises_without_enough_cards(monkeypatch):
    """No quiet single-device path: tp=2 on a host with one card raises
    and names the explicit constructor; with no card at all the device
    check raises first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"TPMesh\(\[torch.device\('cuda:0'\)\] \* 2\)"):
        make_tp_mesh(2, "cuda")
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        make_tp_mesh(2)
    assert make_tp_mesh(1).devices == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tp_mesh(2)
