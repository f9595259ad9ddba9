"""The port's QAT training path against the reference on the CPU:
``_dynamic_fake_quant_ste`` and its STE gradient, the QAT levels tables,
one AdamW update, and ``train()``'s loss trajectory on the
``internlm2_1_8b`` smoke config (with W4A8 QAT and without) from the
reference's own params; the resume contract, exact; the watchdog and the
supervisor. Inputs come from numpy with a seed and go to both sides."""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch import steps as jsteps
from repro.launch.train import train as j_train
from repro.models.context import _dynamic_fake_quant_ste as j_dfq
from repro.models.transformer import init_params as j_init
from repro.optim import adamw as jadam
from repro.quant.policy import BitConfig as JBitConfig
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.fault import Watchdog, supervise
from repro_torch.models.context import QATContext, _dynamic_fake_quant_ste
from repro_torch.optim import adamw as tadam
from repro_torch.quant.policy import BitConfig
from _torch_threads import _one_thread  # noqa: F401


ARCH = "internlm2_1_8b"


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("levels", [15.0, 255.0, 65535.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_fake_quant_ste_matches_reference(dtype, levels):
    """Forward values equal the reference's (its division, its rounding,
    levels >= 32767 as the identity) and the gradient is the identity."""
    rng = np.random.default_rng(int(levels))
    x = (rng.normal(size=(24, 40)) * 0.3 + 0.1).astype(np.float32)
    g = rng.normal(size=(24, 40)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = j_dfq(jx, jnp.float32(levels))
    jgrad = jax.grad(lambda a: jnp.sum((j_dfq(a, jnp.float32(levels))
                                        * jnp.asarray(g, a.dtype)).astype(jnp.float32)))(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    for lv in (levels, torch.tensor(levels)):
        y = _dynamic_fake_quant_ste(tx, lv)
        assert y.dtype == tx.dtype
        np.testing.assert_array_equal(y.detach().float().numpy(), _np32(want))
    (y.float() * torch.from_numpy(g).to(tx.dtype).float()).sum().backward()
    np.testing.assert_array_equal(tx.grad.float().numpy(), _np32(jgrad))


def test_w4_block_under_qat_context_has_at_most_16_values():
    ctx = QATContext({"layers/attn/wq": 15.0}, {"mlp_h": 255.0})
    w = torch.randn(64, 96, generator=torch.Generator().manual_seed(0))
    with ctx.scope("layers"), ctx.scope("attn"):
        qw = ctx.qw("wq", w)
        assert ctx.qw("wk", w) is w
    assert 2 < torch.unique(qw).numel() <= 16
    assert torch.unique(ctx.tap("mlp_h", w)).numel() <= 256


def test_levels_tables_match_reference():
    """``uniform_levels`` and ``bitconfig_to_levels``: the same keys and
    the same (L,) tables / top-level scalars as the reference's."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    want = jsteps.uniform_levels(jcfg, 4, 8)
    got = tsteps.uniform_levels(tcfg, 4, 8, device="cpu")
    nobits = tsteps.uniform_levels(tcfg, 3, None, device="cpu")
    assert nobits.layer_acts == {} and nobits.top_weights == {}
    wb = {"layers/0/attn/wq": 4, "layers/1/mlp/w_up": 8, "layers/1/attn/wq": 16,
          "head": 6}
    ab = {"layers/0/mlp/mlp_h": 8, "embed_out": 8}
    jb = jsteps.bitconfig_to_levels(jcfg, JBitConfig(wb, ab))
    tb = tsteps.bitconfig_to_levels(tcfg, BitConfig(wb, ab), device="cpu")
    for j, t in ((want, got), (jb, tb)):
        for jt, tt in zip(j, t):
            assert sorted(jt) == sorted(tt)
            for key in jt:
                np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=12, schedule=schedule)
    for step in range(0, 15):
        want = jadam.schedule_lr(jadam.AdamWConfig(**cfg), jnp.int32(step))
        got = tadam.schedule_lr(tadam.AdamWConfig(**cfg),
                                torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_update_matches_reference(clip_norm):
    """Three AdamW steps (warmup, cosine decay, clipping, weight decay) on
    an fp32 and a bf16 leaf: params, moments and metrics equal the
    reference's. Tolerance: fp32 2e-6 relative and 1e-8 absolute (the
    schedule's cos/pow and the clipping norm's sum may differ by an ulp
    between the two libraries, and p − lr·delta and the first moment
    cancel near 0); bf16 params within one bf16 ulp (2^-7 relative) for
    the same reason."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(6, 5)).astype(np.float32),
         "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=clip_norm)
    jp = {"a": jnp.asarray(p["a"]), "b": {"c": jnp.asarray(p["b"]["c"], jnp.bfloat16)}}
    tp = {"a": torch.from_numpy(p["a"].copy()),
          "b": {"c": torch.from_numpy(p["b"]["c"]).to(torch.bfloat16)}}
    js, ts = jadam.init_adam(jp), tadam.init_adam(tp)
    for i in range(3):
        g = {"a": rng.normal(size=(6, 5)).astype(np.float32) * 3,
             "b": {"c": rng.normal(size=(7,)).astype(np.float32) * 3}}
        jg = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"], jnp.bfloat16)}}
        tg = {"a": torch.from_numpy(g["a"]),
              "b": {"c": torch.from_numpy(g["b"]["c"]).to(torch.bfloat16)}}
        jp, js, jm = jadam.adamw_update(jadam.AdamWConfig(**cfg), jp, jg, js)
        tp, ts, tm = tadam.adamw_update(tadam.AdamWConfig(**cfg), tp, tg, ts)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=2e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=2e-6)
        np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                                   rtol=2e-6, atol=1e-8)
        np.testing.assert_allclose(tp["b"]["c"].float().numpy(),
                                   _np32(jp["b"]["c"]), rtol=2.0 ** -7)
        assert tp["b"]["c"].dtype == torch.bfloat16
        for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
            np.testing.assert_allclose(tt["a"].numpy(), np.asarray(jt["a"]),
                                       rtol=2e-6, atol=1e-8)
            np.testing.assert_allclose(tt["b"]["c"].numpy(), np.asarray(jt["b"]["c"]),
                                       rtol=2e-6, atol=1e-8)


def _ref_params_init(monkeypatch):
    """Make the port's train() start from the reference train()'s params
    (seed 0; the stacked layers split per layer hold the same values)."""
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = jax.tree.map(np.asarray, j_init(jcfg, jax.random.key(0)))

    def init(cfg, seed=0, device=None):
        return params_from_numpy(jp, device=device, dtype=cfg.param_dtype)

    monkeypatch.setattr(ttrain, "init_params", init)


@pytest.mark.parametrize("qat", [True, False])
def test_train_loss_trajectory_matches_reference(monkeypatch, qat):
    """Five steps of ``train()`` from the same params and batches: the
    losses agree within 1e-5 (fp32 sums in other orders; under QAT an
    activation at a grid boundary may land one step apart)."""
    _ref_params_init(monkeypatch)
    kw = dict(smoke=True, steps=5, batch=4, seq=32, ckpt_dir=None, resume=False,
              ckpt_every=0, qat_weight_bits=4 if qat else None,
              qat_act_bits=8 if qat else None, watchdog_s=None)
    want = j_train(ARCH, **kw)
    got = ttrain.train(ARCH, **kw, device="cpu")
    assert got["steps"] == want["steps"] == 5 and len(got["step_s"]) == 5
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_contract_exact(monkeypatch, tmp_path, dtype):
    """Train 6 steps saving every 3; point LATEST at step 3 (a crash after
    that save); resume and run to 6: the resumed losses 3..5 equal the
    first run's bit for bit (fp32 and bf16 params; bf16 checkpoints round
    trip exactly)."""
    cfg = dataclasses.replace(t_smoke(ARCH), dtype=dtype)
    monkeypatch.setattr(ttrain, "smoke_config", lambda arch: cfg)
    d = str(tmp_path / "ck")
    kw = dict(smoke=True, steps=6, batch=4, seq=32, ckpt_dir=d, ckpt_every=3,
              qat_weight_bits=4, qat_act_bits=8, watchdog_s=None, device="cpu")
    first = ttrain.train(ARCH, resume=False, **kw)
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003", "step_00000006"]
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_00000003")
    again = ttrain.train(ARCH, resume=True, **kw)
    assert len(again["losses"]) == 3
    assert again["losses"] == first["losses"][3:]


def test_watchdog_fires_and_supervise_restarts():
    fired = []
    wd = Watchdog(0.15, on_timeout=lambda: fired.append(1))
    wd.arm()
    time.sleep(0.4)
    assert fired and wd.fired, "watchdog must fire on missed deadline"
    wd.stop()

    fired2 = []
    wd2 = Watchdog(0.15, on_timeout=lambda: fired2.append(1))
    wd2.arm()
    wd2.disarm()
    time.sleep(0.3)
    assert not fired2
    wd2.stop()

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("simulated node failure")

    assert supervise(flaky, max_restarts=5, backoff_s=0.01) == 2
    with pytest.raises(RuntimeError):
        supervise(lambda: (_ for _ in ()).throw(RuntimeError("always")),
                  max_restarts=1, backoff_s=0.01)


def test_train_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(ARCH, True, 1, 1, 8, None, False, 0, None, None, None)
