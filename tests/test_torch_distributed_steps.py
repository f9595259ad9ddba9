"""The port's sharded steps against the reference's single-device
results on the CPU, in process (the reference's own contract in
``tests/test_distributed.py``: a (2,4) step equals the 1-device step),
and against the port's (1,1) mesh and one-device step at the tightest
tolerance that holds: ``build_train_step`` (ZeRO-1, compressed
gradients, FSDP, QAT, an MoE model), ``moe_apply_ep`` through the
prefill step, ``build_prefill_step`` and ``build_decode_step`` at
w8kv8 on a sequence-sharded and a head-sharded cache, and for the ssm
and hybrid families against the reference's mesh decode step. Inputs come from
numpy with a seed; the reference's params go to both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as JShape
from repro.configs import smoke_config as j_smoke
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_state
from repro.models import init_params as j_init
from repro.optim.adamw import init_adam as j_init_adam
from repro.utils.pytree import named_leaves as j_named
from repro_torch.configs import ARCH_IDS, ShapeSpec, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.decode import init_decode_state
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_adam
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
TRAIN = ("t", 32, 4, "train")


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


def _to_torch(jtree, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu",
                             dtype=cfg.param_dtype)


def _unstack(jtree, n_layers):
    """A stacked (scan) parameter tree as the unrolled layout."""
    out = dict(jtree)
    out["layers"] = {str(i): jax.tree.map(lambda a: a[i], jtree["layers"])
                     for i in range(n_layers)}
    return out


def _batch(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_step(cfg, mshape, opts, params, batch, shape=TRAIN, qat=None):
    sb = tsteps.build_train_step(cfg, ShapeSpec(*shape), _mesh(mshape), opts,
                                 qat=qat)
    state, m = sb.fn(tsteps.TrainState(params, init_adam(params)), _tbatch(batch))
    return (float(m["loss"]), float(m["grad_norm"]),
            dict(named_leaves(tsteps.gather(state.params))))


@pytest.fixture(scope="module")
def llama_reference():
    """The reference's (1,1) train step on llama3_8b smoke (its own test's
    single-device side), from its params."""
    jcfg = dataclasses.replace(j_smoke("llama3_8b"), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    batch = _batch(jcfg)
    b1 = jsteps.build_train_step(jcfg, JShape(*TRAIN), j_make_mesh((1, 1), ("data", "model")),
                                 jsh.ShardOptions(zero1=False))
    pj = jax.tree.map(jnp.array, jp)
    s1, m1 = b1.fn(jsteps.TrainState(pj, j_init_adam(pj)), batch)
    want = {n: np.asarray(a, np.float32) for n, a in j_named(s1.params)}
    return jp, batch, float(m1["loss"]), want


# tolerance of the port's (2,4) step against its (1,1) step, by variant:
# fp partial sums folded in another order (ZeRO-1, FSDP); compressed
# gradients carry the int8 grid's rounding of those
TRAIN_VARIANTS = {
    "zero1": (tsh.ShardOptions(zero1=True), 1e-7),
    "compressed": (tsh.ShardOptions(zero1=True, grad_compression=True), 2e-5),
    "fsdp": (tsh.ShardOptions(strategy="fsdp"), 1e-7),
}


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_train_step_2x4_matches_reference_and_1x1(llama_reference, variant):
    """A (2,4) train step of llama3_8b smoke from the reference's params:
    loss within rtol 1e-4 and params within rtol 3e-2 / atol 3e-3 of the
    reference's single-device step (the reference's own bar), and the
    params within the atol above of the port's (1,1) step (the loss
    within rtol 1e-6)."""
    jp, batch, j_loss, want = llama_reference
    cfg = smoke_config("llama3_8b")
    opts, atol = TRAIN_VARIANTS[variant]
    params = _to_torch(jp, cfg)
    loss8, norm8, got8 = _port_step(cfg, (2, 4), opts, params, batch)
    loss1, norm1, got1 = _port_step(cfg, (1, 1), opts, params, batch)
    np.testing.assert_allclose(loss8, j_loss, rtol=1e-4)
    np.testing.assert_allclose(loss8, loss1, rtol=1e-6)
    np.testing.assert_allclose(norm8, norm1, rtol=1e-5 if variant != "compressed"
                               else 1e-3)
    assert sorted(got8) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(got8[n].float().numpy(), w, rtol=3e-2, atol=3e-3,
                                   err_msg=n)
        np.testing.assert_allclose(got8[n].numpy(), got1[n].numpy(), rtol=0,
                                   atol=atol, err_msg=n)


def _one_device_rows(cfg, params, batch, rows, qat=None):
    """One AdamW step of the port's one-device code on the mean of the
    ``rows`` data rows' gradients (each row's ``loss_fn`` on its slice of
    the batch): what a data-parallel step computes. Returns (the rows'
    mean loss, params)."""
    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.utils.pytree import map_with_names
    p = map_with_names(lambda _, t: t.detach().clone().requires_grad_(True), params)
    leaves = named_leaves(p)
    n = batch["tokens"].shape[0] // rows
    losses, acc = [], None
    for r in range(rows):
        sl = {k: torch.from_numpy(v[r * n:(r + 1) * n]) for k, v in batch.items()}
        loss = loss_fn(p, sl, cfg, qat=qat)
        g = torch.autograd.grad(loss, [t for _, t in leaves])
        acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
        losses.append(float(loss.detach()))
    by_name = {name: a / rows for (name, _), a in zip(leaves, acc)}
    with torch.no_grad():
        p, _, m = adamw_update(AdamWConfig(), p, map_with_names(
            lambda name, _: by_name[name], p), init_adam(p))
    return sum(losses) / rows, float(m["grad_norm"]), dict(named_leaves(p))


@pytest.mark.parametrize("case", ["fsdp-batch-over-model", "qat-w4a8", "moe-ep"])
def test_train_step_matches_one_device_rows(case):
    """The (2,4) step against the port's one-device code on the data
    rows' mean gradient: FSDP with a batch of 8 split over ("data",
    "model"), so the four shards of a data row share its parameter parts
    (8 rows of one sequence); W4A8 QAT, each weight shard fake-quantized
    on the whole weight's grid (a shard-local range would move it), and
    each data row's activations on their own range (2 rows); olmoe's
    expert-parallel MoE, gradients through ``moe_apply_ep`` and the aux
    loss a row's (the reference ``pmean``s it over the data axes: 2 rows).
    On (1,4) the QAT loss equals the one-device step's within 1e-6.
    Tolerance: loss rtol 1e-5, the gradient's global norm rtol 1e-4,
    params atol 1e-6 (QAT: norm 1e-2 and params 3e-3, the reference's
    bar: an activation whose fp sum moved by an ulp may round to the
    next grid point)."""
    arch = "olmoe_1b_7b" if case == "moe-ep" else "llama3_8b"
    cfg = smoke_config(arch)
    if case == "moe-ep":
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = init_params(cfg, seed=0, device="cpu")
    b = 8 if case.startswith("fsdp") else 4
    batch = _batch(cfg, b=b)
    qat = tsteps.uniform_levels(cfg, 4, 8, device="cpu") if case.startswith("qat") else None
    opts = tsh.ShardOptions(strategy="fsdp") if case.startswith("fsdp") \
        else tsh.ShardOptions(zero1=True)
    shape = ("t", 32, b, "train")
    rules = tsh.make_rules(cfg, ShapeSpec(*shape), _mesh((2, 4)), opts)
    rows = 8 if case.startswith("fsdp") else 2
    assert rules.table["batch"] == (("data", "model") if rows == 8 else ("data",))
    loss8, norm8, got8 = _port_step(cfg, (2, 4), opts, params, batch, shape=shape,
                                    qat=qat)
    loss1, norm1, got1 = _one_device_rows(cfg, params, batch, rows, qat)
    np.testing.assert_allclose(loss8, loss1, rtol=1e-5)
    np.testing.assert_allclose(norm8, norm1, rtol=1e-4 if qat is None else 1e-2)
    atol = 3e-3 if qat is not None else 1e-6
    for n, w in got1.items():
        np.testing.assert_allclose(got8[n].numpy(), w.detach().numpy(), rtol=0,
                                   atol=atol, err_msg=n)
    if qat is not None:
        loss4, norm4, _ = _port_step(cfg, (1, 4), opts, params, batch, shape=shape,
                                     qat=qat)
        loss_one, norm_one, _ = _one_device_rows(cfg, params, batch, 1, qat)
        np.testing.assert_allclose(loss4, loss_one, rtol=1e-6)
        np.testing.assert_allclose(norm4, norm_one, rtol=1e-2)


@pytest.mark.parametrize("arch,mshape,moe_mode", [
    ("olmoe_1b_7b", (2, 4), "ep"), ("deepseek_moe_16b", (2, 4), "ep"),
    ("olmoe_1b_7b", (1, 16), "tp")])
def test_moe_forward_on_mesh_matches_reference(arch, mshape, moe_mode):
    """The reference's contract: the sharded MoE forward (here the
    prefill step; on (2,4) ``moe_apply_ep``, 2 experts a shard; on (1,16)
    the 8 experts do not divide, so MoE-TP splits the expert hidden dim)
    equals the single-device forward at capacity factor 16 within 2e-3
    relative error; and the port's (1,1) mesh within 1e-5."""
    jcfg = dataclasses.replace(j_smoke(arch), capacity_factor=16.0, scan_layers=False)
    cfg = dataclasses.replace(smoke_config(arch), capacity_factor=16.0)
    jp = j_init(jcfg, jax.random.key(0))
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, i: j_forward(p, i, jcfg)[0])(
        jp, {"tokens": jnp.asarray(tok)}))
    params = _to_torch(jp, cfg)
    shape = ShapeSpec("p", 32, 4, "prefill")
    opts = tsh.ShardOptions(moe_mode=moe_mode)
    outs = {}
    for ms in (mshape, (1, 1)):
        sb = tsteps.build_prefill_step(cfg, shape, _mesh(ms), opts)
        outs[ms] = sb.fn(params, {"tokens": torch.from_numpy(tok)}).full().numpy()
    scale = np.abs(ref).max()
    assert np.abs(outs[mshape] - ref).max() / scale < 2e-3
    assert np.abs(outs[mshape] - outs[(1, 1)]).max() / scale < 1e-5


def test_prefill_step_matches_reference_forward():
    """``build_prefill_step`` on (2,4) (column/row blocks, the D-sharded
    embedding, the vocab-sharded head) and on (1,1): logits within 1e-5
    of the reference's single-device forward, relative to its largest."""
    jcfg = dataclasses.replace(j_smoke("llama3_8b"), scan_layers=False)
    cfg = smoke_config("llama3_8b")
    jp = j_init(jcfg, jax.random.key(1))
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    ref = np.asarray(j_forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)[0])
    params = _to_torch(jp, cfg)
    for ms in ((2, 4), (1, 1)):
        sb = tsteps.build_prefill_step(cfg, ShapeSpec("p", 32, 4, "prefill"), _mesh(ms))
        assert set(sb.args[1]) == {"tokens"} and sb.args[1]["tokens"].is_meta
        got = sb.fn(params, {"tokens": torch.from_numpy(tok)})
        assert tuple(got.shape) == ref.shape
        assert np.abs(got.full().numpy() - ref).max() / np.abs(ref).max() < 1e-5


DECODE_STEPS = 4


def test_decode_w8kv8_matches_reference():
    """``quantize_decode_params`` payloads byte-identical to the
    reference's (its stacked leaves, the unrolled layout here) with equal
    scales; ``build_decode_step(w8kv8)``'s greedy tokens over 4 steps
    equal the reference's single-device step on a (2,4) mesh (the 2 kv
    heads do not divide 4: the cache's positions are sharded, softmax
    partials combined across shards), a (2,2) mesh (the kv heads
    sharded) and (1,1); with the real scales, (2,4) == (2,2) == (1,1).
    Logits within 1e-4 of the reference's, relative to its largest."""
    jcfg = j_smoke("llama3_8b")
    cfg = smoke_config("llama3_8b")
    b, t = 4, 16
    jp = j_init(jcfg, jax.random.key(2))
    jq, jscales = jsteps.quantize_decode_params(jp, jcfg)
    params = _to_torch(_unstack(jp, jcfg.num_layers), cfg)
    qp, scales = tsteps.quantize_decode_params(params, cfg)
    assert sorted(scales) == sorted(jscales)
    for k in jscales:
        assert float(scales[k]) == float(jscales[k]), k
    jq_un = jax.tree.map(np.asarray, _unstack(jq, jcfg.num_layers))
    for (n, a), (_, w) in zip(named_leaves(qp), j_named(jq_un)):
        assert a.dtype == (torch.int8 if w.dtype == np.int8 else a.dtype), n
        if w.dtype == np.int8:
            np.testing.assert_array_equal(a.numpy(), w, err_msg=n)

    shape = JShape("d", t, b, "decode")
    jopts = jsh.ShardOptions(decode_quant="w8kv8")
    jb = jsteps.build_decode_step(jcfg, shape, j_make_mesh((1, 1), ("data", "model")), jopts)
    st = j_init_state(jcfg, b, t)
    st = st._replace(kv=jax.tree.map(lambda c: c.astype(jnp.int8), st.kv))
    tok0 = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    tok, want_tokens, want_logits = jnp.asarray(tok0), [], []
    for _ in range(DECODE_STEPS):
        logits, st = jb.fn(jq, st, tok)
        want_logits.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want_tokens.append(np.asarray(tok)[:, 0].tolist())

    def run(mshape, real):
        sb = tsteps.build_decode_step(cfg, ShapeSpec("d", t, b, "decode"), _mesh(mshape),
                                      tsh.ShardOptions(decode_quant="w8kv8"))
        state = init_decode_state(cfg, b, t, device="cpu", kv_dtype=torch.int8)
        tk, toks, lg = torch.from_numpy(tok0), [], []
        for _ in range(DECODE_STEPS):
            logits, state = sb.fn(qp, state, tk, scales=scales if real else None)
            full = logits.full()
            lg.append(full.numpy())
            tk = torch.argmax(full[:, -1], -1)[:, None].to(torch.int32)
            toks.append(tk[:, 0].tolist())
        return sb, toks, lg

    modes = {(2, 4): "seq", (2, 2): "heads", (1, 1): "heads"}
    real = {}
    for ms, mode in modes.items():
        sb, toks, lg = run(ms, False)
        kv_spec = tuple(sb.shardings[1].kv.k.spec)
        assert ("model" in kv_spec) and kv_spec.index("model") == (2 if mode == "seq" else 3)
        assert toks == want_tokens, (ms, toks, want_tokens)
        scale = max(np.abs(w).max() for w in want_logits)
        for a, w in zip(lg, want_logits):
            assert np.abs(a - w).max() / scale < 1e-4, ms
        real[ms] = run(ms, True)[1]
    assert real[(2, 4)] == real[(2, 2)] == real[(1, 1)]


def test_build_step_dispatches_and_refuses_recurrent_decode():
    """``build_step`` picks the builder by shape kind; its stand-ins are
    meta tensors (nothing allocated); the audio family's tokens are
    (B, S, CB) grids; the recurrent families' mesh decode builds, as the
    reference's does (it was refused until the port sharded their
    state), with meta stand-ins of their SSM states."""
    cfg = smoke_config("llama3_8b")
    m = _mesh((1, 2))
    for kind, fn in (("train", "train_step"), ("prefill", "prefill_step"),
                     ("decode", "serve_step")):
        sb = tsteps.build_step(cfg, ShapeSpec("s", 16, 2, kind), m)
        assert sb.fn.__name__ == fn and sb.rules.mesh is m
        params = sb.args[0].params if kind == "train" else sb.args[0]
        inputs = [sb.args[-1]] if kind == "decode" else list(sb.args[-1].values())
        metas = [t for _, t in named_leaves(params)] + inputs
        assert metas and all(t.is_meta for t in metas)
    specs = tsteps.input_specs(smoke_config("musicgen_large"), ShapeSpec("s", 16, 2, "train"))
    assert tuple(specs["tokens"].shape) == (2, 16, smoke_config("musicgen_large").num_codebooks)
    for arch in ("mamba2_130m", "zamba2_7b"):
        sb = tsteps.build_decode_step(smoke_config(arch), ShapeSpec("d", 16, 2, "decode"), m)
        assert sb.fn.__name__ == "serve_step"
        assert sb.args[1].ssm.h.is_meta and sb.args[1].ssm.h.dtype == torch.float32


def _family_inputs(cfg, kind, seed=0):
    """A smoke batch of every input ``input_specs`` names (int tokens,
    fp image patches) for a 4 × 16 shape of ``kind``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, m in tsteps.input_specs(cfg, ShapeSpec("s", 16, 4, kind)).items():
        if m.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(0, cfg.vocab_size, tuple(m.shape))
                                      .astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.normal(size=tuple(m.shape))
                                      .astype(np.float32)).to(m.dtype)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_every_family_on_the_mesh(arch):
    """Every family's prefill step on (2,2) and (1,4) against the port's
    plain forward (held against the reference in each family's tests):
    "tp" within 1e-5 relative to the largest logit (row blocks add fp
    partials in shard order); "fsdp" bit for bit (whole matmuls on
    gathered weights; the audio family's per-codebook tables and the
    D-sharded embedding looked up shard by shard) but for MoE, which
    runs ``moe_apply_ep`` under either strategy. The MoE families at
    capacity factor 16: a binding capacity is a data row's on a mesh
    (the reference's ``moe_apply_ep``), which drops other tokens than
    the whole batch's."""
    from repro_torch.models.transformer import forward
    cfg = smoke_config(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = init_params(cfg, seed=0, device="cpu")
    inputs = _family_inputs(cfg, "prefill")
    with torch.no_grad():
        ref = forward(params, inputs, cfg)[0]
    for ms in ((2, 2), (1, 4)):
        for strategy in ("tp", "fsdp"):
            sb = tsteps.build_prefill_step(cfg, ShapeSpec("p", 16, 4, "prefill"),
                                           _mesh(ms), tsh.ShardOptions(strategy=strategy))
            got = sb.fn(params, inputs).full()
            if strategy == "fsdp" and cfg.family != "moe":
                assert torch.equal(got, ref), (ms, strategy)
            else:
                assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5, ms


@pytest.mark.parametrize("arch", ["musicgen_large", "mamba2_130m", "zamba2_7b"])
def test_train_step_other_families_on_the_mesh(arch):
    """The audio, ssm and hybrid families' (2,2) ZeRO-1 train step
    against their (1,1) step: loss rtol 1e-6 and the gradient's global
    norm rtol 1e-5 (the hybrid's shared block read through its shared/<g>
    scopes, the Mamba2 scalars replicated and their gradients psum'd)."""
    cfg = smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    batch = {k: v.numpy() for k, v in _family_inputs(cfg, "train").items()}
    shape = ("t", 16, 4, "train")
    loss4, norm4, _ = _port_step(cfg, (2, 2), tsh.ShardOptions(zero1=True), params,
                                 batch, shape=shape)
    loss1, norm1, _ = _port_step(cfg, (1, 1), tsh.ShardOptions(zero1=True), params,
                                 batch, shape=shape)
    np.testing.assert_allclose(loss4, loss1, rtol=1e-6)
    np.testing.assert_allclose(norm4, norm1, rtol=1e-5)


def _unstack_stacks(jtree):
    """The reference's scan layout (``layers`` (L, ...), the hybrid's
    ``groups`` (G, period, ...) and ``rest`` (R, ...)) as the unrolled
    one, in numpy."""
    out = {}
    for k, v in jtree.items():
        if k in ("layers", "rest"):
            n = jax.tree.leaves(v)[0].shape[0]
            out[k] = {str(i): jax.tree.map(lambda a, i=i: np.asarray(a[i]), v)
                      for i in range(n)}
        elif k == "groups":
            g, per = jax.tree.leaves(v)[0].shape[:2]
            out[k] = {str(i): {str(j): jax.tree.map(
                lambda a, i=i, j=j: np.asarray(a[i, j]), v) for j in range(per)}
                for i in range(g)}
        else:
            out[k] = jax.tree.map(np.asarray, v)
    return out


def _fp_mamba_d(jq, jp):
    """The reference's int8 tree with the Mamba2 skip scale ``D`` put back
    in fp: its stacked (L, H) leaf is 2-D, so the reference quantizes it,
    and the decode then reads the raw int8 values (no scale); the port
    keeps ``D`` fp32 (``ROADMAP.md`` § C)."""
    from repro.utils.pytree import map_with_names as j_map
    fp = dict(j_named(jp))
    assert all(a.dtype == jnp.int8 for n, a in j_named(jq) if n.endswith("mixer/D"))
    return j_map(lambda n, a: fp[n] if n.endswith("mixer/D") else a, jq)


def _j_state_specs(jcfg, jstate, mshape, opts):
    from jax.sharding import AbstractMesh
    jm = AbstractMesh(mshape, ("data", "model"))
    shape = JShape("d", 16, 4, "decode")
    sh = jsteps.decode_state_pspecs(jstate, jcfg, shape, jm, opts,
                                    jsh.make_rules(jcfg, shape, jm, opts))
    return {n: tuple(s.spec) for n, s in j_named(sh)}


def _t_state_specs(sb):
    return {n: tuple(s.spec) for n, s in tsteps._state_names(sb.shardings[1])}


@pytest.mark.parametrize("arch,quant", [("mamba2_130m", None), ("zamba2_7b", None), ("mamba2_130m", "w8"),
                                        ("zamba2_7b", "w8kv8")])
def test_recurrent_decode_on_the_mesh_matches_reference(arch, quant):
    """The ssm and hybrid families' ``build_decode_step`` (R9) on (1,1),
    (2,2) and (2,4) CPU meshes: greedy tokens over 4 steps equal to the
    reference's ``build_decode_step`` (its (1,1) mesh, in process), logits
    within 1e-4 of the reference's relative to its largest (the port's
    mesh against its own (1,1) within 1e-5: row blocks add fp partials in
    shard order; the recurrence runs whole on a row's lead), the SSM
    state's and the shared block's cache specs
    equal to the reference's ``decode_state_pspecs``, and the state
    advanced in place: the (2,4) mesh's gathered state equals the (1,1)
    mesh's. "w8" quantizes the weights (payloads byte-identical to the
    reference's; both sides at ``build_decode_step``'s abstract 0.01 scales), "kv8"
    also the hybrid's shared-block cache; the SSM states stay fp32."""
    jcfg = j_smoke(arch)
    cfg = smoke_config(arch)
    b, t = 4, 16
    jp = j_init(jcfg, jax.random.key(3))
    params = _to_torch(_unstack_stacks(jp), cfg)
    jopts = jsh.ShardOptions(decode_quant=quant)
    jq = jp
    if quant:
        # int8 payloads byte-identical to the reference's; both sides
        # decode at build_decode_step's abstract 0.01 scales
        jq, _ = jsteps.quantize_decode_params(jp, jcfg)
        jq = _fp_mamba_d(jq, jp)
        params, _ = tsteps.quantize_decode_params(params, cfg)
        want_q = dict(j_named(_unstack_stacks(jq)))
        for n, a in named_leaves(params):
            if a.dtype == torch.int8:
                np.testing.assert_array_equal(a.numpy(), want_q[n], err_msg=n)
    jb = jsteps.build_decode_step(jcfg, JShape("d", t, b, "decode"),
                                  j_make_mesh((1, 1), ("data", "model")), jopts)
    st = j_init_state(jcfg, b, t)
    if quant and st.kv is not None:
        st = st._replace(kv=jax.tree.map(lambda c: c.astype(jnp.int8), st.kv))
    tok0 = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    tok, want_tokens, want_logits = jnp.asarray(tok0), [], []
    for _ in range(DECODE_STEPS):
        logits, st = jb.fn(jq, st, tok)
        want_logits.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want_tokens.append(np.asarray(tok)[:, 0].tolist())
    jstate = j_init_state(jcfg, b, t, abstract=True)

    got = {}
    for ms in ((1, 1), (2, 2), (2, 4)):
        sb = tsteps.build_decode_step(cfg, ShapeSpec("d", t, b, "decode"), _mesh(ms),
                                      tsh.ShardOptions(decode_quant=quant))
        specs = _t_state_specs(sb)
        want_specs = _j_state_specs(jcfg, jstate, ms, jopts)
        assert {n: tuple(_norm_spec(e) for e in s) for n, s in specs.items()} == \
            {n: tuple(_norm_spec(e) for e in s) for n, s in want_specs.items()}, ms
        state = init_decode_state(cfg, b, t, device="cpu",
                                  kv_dtype=torch.int8 if quant else None)
        assert state.ssm.h.dtype == torch.float32
        tk, toks, lg = torch.from_numpy(tok0), [], []
        for _ in range(DECODE_STEPS):
            logits, state = sb.fn(params, state, tk)
            full = logits.full()
            lg.append(full.numpy())
            tk = torch.argmax(full[:, -1], -1)[:, None].to(torch.int32)
            toks.append(tk[:, 0].tolist())
        assert toks == want_tokens, (ms, toks, want_tokens)
        scale = max(np.abs(w).max() for w in want_logits)
        for a, w in zip(lg, want_logits):
            assert np.abs(a - w).max() / scale < 1e-4, ms
        got[ms] = (lg, tsteps.gather(state))
    for ms in ((2, 2), (2, 4)):
        for a, w in zip(got[ms][0], got[(1, 1)][0]):
            assert np.abs(a - w).max() / np.abs(w).max() < 1e-5, ms
        for (n, a), (_, w) in zip(tsteps._state_names(got[ms][1]),
                                  tsteps._state_names(got[(1, 1)][1])):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            w if isinstance(w, tuple) else (w,)):
                assert torch.allclose(x.float(), y.float(), rtol=1e-4, atol=1e-5), (ms, n)


def _norm_spec(e):
    if isinstance(e, (list, tuple)):
        return tuple(e) if len(e) > 1 else (e[0] if e else None)
    return e
