"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``tests/test_analysis.py``), case by case, on the CPU.

  * findings plumbing — Finding/Report validation, the reasoned marker;
  * lint (RPR0xx) — one planted fault per rule in its torch form, and
    the forms that must stay quiet;
  * dispatch (RPR1xx) — planted faults run under the recording dispatch
    mode (float64, lossy int32 casts, host syncs in a hot target, a
    floating cross-shard sum) and the safe constructions; the repaired
    ``rope_freqs`` (it made a host tensor in every attention layer of
    every decode step: a synchronizing upload on the card);
  * bounds (RPR2xx) — the arithmetic, the raising validators, and
    ``verify_configs`` equal to the reference's on every architecture;
  * ``launch.roofline`` — ``param_counts`` and ``model_flops`` equal to
    the reference's on every architecture and shape;
  * the shipped tree — lint clean, ``run_all(device="cpu")`` clean with
    the ``moe-ep`` target, the CLI in a subprocess.

The reference's own float64, callback and fp-psum fixtures fail under
the installed JAX; their counterparts here hold the port's checker to
the same contracts on its own graphs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401
from repro_torch.analysis import RULES, Report, run_all
from repro_torch.analysis import bounds as B
from repro_torch.analysis.dispatch_check import check_ops, record
from repro_torch.analysis.findings import Finding, suppressed_codes
from repro_torch.analysis.lint import _check_pack_tables, lint_source
from repro_torch.launch.mesh import TPMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def codes(findings):
    return sorted(f.code for f in findings)


def dispatch(fn, hot=False, engine=False):
    """The RPR1xx findings of ``fn()`` run under the recorder."""
    rec, syncs = record(fn, CPU)
    return check_ops(rec.ops, "fixture", hot=hot, engine=engine, syncs=syncs)


# ---------------------------------------------------------------------------
# findings plumbing
# ---------------------------------------------------------------------------

def test_finding_validates_code_and_severity():
    with pytest.raises(ValueError, match="unknown rule code"):
        Finding("RPR999", "error", "x", "m")
    with pytest.raises(ValueError, match="unknown severity"):
        Finding("RPR001", "fatal", "x", "m")
    f = Finding("RPR201", "error", "t", "boom", line=3, path="a/b.py")
    assert "a/b.py:3" in f.render() and f.render().startswith("ERROR")
    assert f.render_github().startswith("::error file=a/b.py,line=3::RPR201:")
    assert Finding("RPR100", "info", "t", "50% done\nnext").render_github() \
        == "::notice::RPR100: 50%25 done%0Anext"


def test_rules_are_the_reference_codes():
    from repro.analysis.findings import RULES as J
    assert list(RULES) == list(J)
    assert all("jax" not in text.lower() for text in RULES.values())


def test_report_exit_code_severity_tiers():
    r = Report()
    r.add(Finding("RPR203", "warning", "t", "rounding tier"))
    r.add(Finding("RPR100", "info", "t", "env note"))
    assert r.exit_code() == 0                    # warnings/info tolerated
    r.extend([Finding("RPR201", "error", "t", "overflow")])
    assert r.exit_code() == 1 and len(r.errors) == 1 and len(r.warnings) == 1


def test_suppression_marker_requires_reason():
    lines = ["x = f()  # rpr-ok: RPR002 int32 operand",
             "# rpr-ok: RPR003",            # bare marker: no reason
             "y = g()"]
    assert suppressed_codes(lines, 1) == {"RPR002"}
    assert suppressed_codes(lines, 3) == set()   # reasonless marker ignored
    # marker on the line above the flagged one
    assert suppressed_codes(["# rpr-ok: RPR007 bounds-checked", "assert x"],
                            2) == {"RPR007"}


# ---------------------------------------------------------------------------
# lint fixtures (RPR0xx), torch forms
# ---------------------------------------------------------------------------

def test_lint_rpr001_quantize_pack_unit_violation():
    fs = lint_source("w = quantize(x, 6, group_size=6)\n", "repro_torch/m.py")
    assert codes(fs) == ["RPR001"] and "pack unit (4)" in fs[0].message
    assert codes(lint_source("w = qt_quantize(x, bits=4, group_size=9)\n",
                             "repro_torch/m.py")) == ["RPR001"]
    assert lint_source("w = quantize(x, bits=4, group_size=8)\n",
                       "repro_torch/s.py") == []
    # non-literal args: not statically decidable, stays quiet
    assert lint_source("w = quantize(x, bits, group_size=g)\n",
                       "repro_torch/s.py") == []


@pytest.mark.parametrize("call", ["mesh.psum(parts)", "self.mesh.psum([a, b])",
                                  "dist.all_reduce(x)", "psum_scatter(x, 'tp')",
                                  "all_gather_invariant(x)"])
def test_lint_rpr002_unmarked_collective(call):
    assert codes(lint_source(f"y = {call}\n", "repro_torch/m.py")) == ["RPR002"]
    ok = ("# rpr-ok: RPR002 int32 operand - integer adds are exact\n"
          f"y = {call}\n")
    assert lint_source(ok, "repro_torch/m.py") == []
    # concatenation is not a sum
    assert lint_source("y = mesh.all_gather(parts, dim=0)\n",
                       "repro_torch/m.py") == []


@pytest.mark.parametrize("src", ["y = x.to(torch.float64)\n",
                                 "y = torch.zeros(3, dtype=torch.double)\n",
                                 "y = x.double()\n",
                                 "y = x.to(getattr(torch, 'float64'))\n"])
def test_lint_rpr003_float64(src):
    assert codes(lint_source(src, "repro_torch/m.py")) == ["RPR003"]


def test_lint_rpr003_host_doubles_are_fine():
    for src in ("y = x.astype(np.float64)\n", "y = np.zeros(3, np.float64)\n",
                "z = x.to(torch.float32)\n"):
        assert lint_source(src, "repro_torch/m.py") == []


def test_lint_rpr004_and_rpr007_kernel_grade_rules():
    src = "v = float(levels)\nn = x.sum().item()\nassert x.shape[0] == k\n"
    fs = lint_source(src, "repro_torch/kernels/foo.py")
    assert codes(fs) == ["RPR004", "RPR004", "RPR007"]
    assert [f.severity for f in fs] == ["warning", "warning", "error"]
    # the same code outside kernels/ is not held to kernel grade
    assert lint_source(src, "repro_torch/core/foo.py") == []
    # float() on a literal is fine even in kernels
    assert lint_source("v = float(2)\n", "repro_torch/kernels/foo.py") == []


def test_lint_rpr006_set_iteration_order_hazard():
    fs = lint_source("out = [f(k) for k in set(names)]\n", "repro_torch/m.py")
    assert codes(fs) == ["RPR006"]
    assert codes(lint_source("for k in {a, b}:\n    f(k)\n",
                             "repro_torch/m.py")) == ["RPR006"]
    assert lint_source("out = [f(k) for k in sorted(set(names))]\n",
                       "repro_torch/m.py") == []


def test_lint_rpr005_pack_tables():
    assert _check_pack_tables() == []
    # a width with no unit, and a unit too small for its values
    fs = _check_pack_tables(packed_bits=(6, 4, 3, 5),
                            units={6: (4, 3), 4: (2, 1), 3: (3, 1)})
    assert codes(fs) == ["RPR005", "RPR005"]


HOT_SRC = """
class Engine:
    def _burst(self, steps):
        ys = self._engine_step(steps)
        return ys.cpu().numpy()

    def _engine_step(self, steps):
        n = int(self._dnw.sum().item())
        torch.cuda.synchronize()
        return self._ys.tolist(), np.asarray(self._tok)

    def _admit(self, req):
        return self._tok.cpu()
"""


def test_lint_rpr008_host_sync_in_hot_functions():
    fs = lint_source(HOT_SRC, "repro_torch/serve/engine.py")
    assert codes(fs) == ["RPR008"] * 6
    assert sorted({f.line for f in fs}) == [5, 8, 9, 10]
    # outside serve/ and obs/, or outside a hot function: quiet
    assert lint_source(HOT_SRC, "repro_torch/models/engine.py") == []
    spec = HOT_SRC.replace("_engine_step", "_spec_step")
    assert codes(lint_source(spec, "repro_torch/serve/engine.py")) == \
        ["RPR008"] * 6
    marked = HOT_SRC.replace(
        "        return ys.cpu().numpy()",
        "        # rpr-ok: RPR008 the burst's one host read\n"
        "        return ys.cpu().numpy()")
    assert sorted({f.line for f in lint_source(
        marked, "repro_torch/serve/engine.py")}) == [9, 10, 11]
    assert codes(lint_source("def drain(c):\n    return c.cpu()\n",
                             "repro_torch/obs/counters.py")) == ["RPR008"]


def test_lint_pass_clean_on_repo_tree():
    from repro_torch.analysis import lint
    fs = lint.run()
    assert [f for f in fs if f.severity == "error"] == [], \
        "\n".join(f.render() for f in fs)
    # the audited sites carry reasoned markers
    src = open(os.path.join(ROOT, "src/repro_torch/serve/engine.py")).read()
    assert src.count("# rpr-ok: RPR008") == 2


# ---------------------------------------------------------------------------
# dispatch fixtures (RPR1xx)
# ---------------------------------------------------------------------------

def test_dispatch_rpr101_float64():
    x = torch.zeros(3)
    fs = dispatch(lambda: x.to(torch.float64) * 2.0)
    assert codes(fs) == ["RPR101"]
    assert dispatch(lambda: x * 2.0) == []


@pytest.mark.parametrize("dst", [torch.bfloat16, torch.float16])
def test_dispatch_rpr102_lossy_int32_downcast(dst):
    acc = torch.zeros(4, dtype=torch.int32)
    fs = dispatch(lambda: acc.to(dst))
    assert codes(fs) == ["RPR102"] and "int32 -> " in fs[0].message
    out = torch.zeros(4, dtype=dst)
    assert codes(dispatch(lambda: out.copy_(acc))) == ["RPR102"]


def test_dispatch_exact_widenings_not_flagged():
    # int32 -> fp32 is the bounds pass's 2^24 tier; int8 -> bf16 is exact
    a, b = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int8)
    assert dispatch(lambda: (a.to(torch.float32), b.to(torch.bfloat16))) == []


HOT_FAULTS = {
    "item": lambda x: x.sum().item(),
    "int": lambda x: int(x[0]),
    "bool": lambda x: bool(x[0] > 0),
    "where_one_arg": lambda x: torch.where(x > 0),
    "nonzero": lambda x: torch.nonzero(x),
    "mask_index": lambda x: x[x > 0],
    "masked_select": lambda x: torch.masked_select(x, x > 0),
    "unique": lambda x: torch.unique(x),
    "repeat_interleave": lambda x: torch.repeat_interleave(
        x, torch.ones(3, dtype=torch.int64)),
    "host_tensor": lambda x: x * torch.tensor(2.0),
}


@pytest.mark.parametrize("fault", sorted(HOT_FAULTS))
def test_dispatch_rpr103_sync_only_in_hot_path(fault):
    x = torch.ones(3)
    fs = dispatch(lambda: HOT_FAULTS[fault](x), hot=True)
    assert codes(fs) == ["RPR103"], fs
    assert "test_torch_analysis.py" in fs[0].message   # the calling line
    # prefill-grade (hot=False) tolerates it
    assert dispatch(lambda: HOT_FAULTS[fault](x), hot=False) == []


def test_dispatch_rpr103_safe_constructions():
    x = torch.ones(3)
    reps = torch.ones(3, dtype=torch.int64)
    safe = (lambda: torch.where(x > 0, x, 0.0),
            lambda: torch.repeat_interleave(x, reps, output_size=3),
            lambda: torch.repeat_interleave(x, 2),
            lambda: torch.full((), 2.0) * x,
            lambda: x.masked_fill(x > 0, 0.0))
    for fn in safe:
        assert dispatch(fn, hot=True) == []


def test_rope_freqs_builds_no_host_tensor():
    """The repaired fault: ``rope_freqs`` made ``theta`` with
    ``torch.tensor(theta, device=...)``, a pageable host-to-device copy
    on the card in every attention layer of every decode step. Built by
    device ops alone it gives the same bits and no RPR103."""
    from repro_torch.models.layers import apply_rope, rope_freqs

    def old_rope_freqs(head_dim, theta, device=None):
        e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
        return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=device), e)

    for dh, theta in ((128, 1e6), (64, 10000.0), (96, 5e5)):
        assert torch.equal(rope_freqs(dh, theta, CPU),
                           old_rope_freqs(dh, theta, CPU))
    assert codes(dispatch(lambda: old_rope_freqs(128, 1e6, CPU),
                          hot=True)) == ["RPR103"]
    x = torch.randn(2, 1, 4, 16)
    pos = torch.tensor([[3], [7]])
    assert dispatch(lambda: apply_rope(x, pos, 1e6), hot=True) == []


def test_dispatch_rpr104_floating_psum_in_engine_targets():
    mesh = TPMesh([CPU] * 2)
    f32 = [torch.ones(4), torch.ones(4)]
    i32 = [torch.ones(4, dtype=torch.int32)] * 2
    fs = dispatch(lambda: mesh.psum(f32), engine=True)
    assert codes(fs) == ["RPR104"] and "float32" in fs[0].message
    # integer adds are exact; concatenation is not a sum
    assert dispatch(lambda: mesh.psum(i32), engine=True) == []
    assert dispatch(lambda: mesh.all_gather(f32, dim=0), engine=True) == []
    # outside an engine target (the data-parallel EF sums) it stays quiet
    assert dispatch(lambda: mesh.psum(f32), engine=False) == []
    # the wrap is undone after the run
    assert TPMesh.psum.__name__ == "psum"


# ---------------------------------------------------------------------------
# bounds (RPR2xx)
# ---------------------------------------------------------------------------

def test_bounds_arithmetic_pins_the_published_limits():
    # W8A8: qmax 127 each -> 16129/term; 2^31 wrap at group 133145
    assert B.max_safe_group(8, 8) == (2**31 - 1) // (127 * 127)
    assert B.fp32_exact_group(8, 8) == 2**24 // (127 * 127)
    g = B.max_safe_group(8, 8)
    assert codes(B.check_group_dot(8, 8, g, "t")) == ["RPR203"]
    assert codes(B.check_group_dot(8, 8, g + 1, "t")) == ["RPR201"]
    assert B.check_group_dot(8, 8, B.fp32_exact_group(8, 8), "t") == []
    fs = B.check_group_dot(8, 8, 2048, "t")
    assert codes(fs) == ["RPR203"] and fs[0].severity == "warning"
    assert codes(B.check_full_k(8, 8, 200_000, "t")) == ["RPR202"]
    assert B.check_full_k(8, 8, 8192, "t") == []


def test_bounds_validators_raise_with_rule_codes():
    with pytest.raises(ValueError, match="RPR201"):
        B.require_group_dot_safe(8, 8, 140_000, where="t")
    with pytest.raises(ValueError, match="RPR202"):
        B.require_full_k_safe(8, 8, 140_000, where="t")
    B.require_group_dot_safe(4, 8, 4096, where="t")      # safe: no raise
    with pytest.raises(ValueError, match="budget_bits"):
        B.require_act_alloc_sane(float("nan"), [8.0], [4, 8])
    with pytest.raises(ValueError, match="non-positive"):
        B.require_act_alloc_sane(100.0, [0.0], [4, 8])
    with pytest.raises(ValueError, match="container range"):
        B.require_act_alloc_sane(100.0, [8.0], [4, 32])


def test_bounds_verify_configs_equal_reference():
    """Every registered architecture: the same findings as the
    reference's pass (code, severity, where and message), in its order;
    no error, the W8 per-channel warning tier present."""
    from repro.analysis.bounds import verify_configs as j_verify
    from repro_torch.configs import ARCH_IDS

    got, want = B.verify_configs(), j_verify()
    key = [(f.code, f.severity, f.where, f.message) for f in got]
    assert key == [(f.code, f.severity, f.where, f.message) for f in want]
    assert {f.where.split(":")[0] for f in got} == set(ARCH_IDS)
    assert [f for f in got if f.severity == "error"] == []
    assert any(f.code == "RPR203" for f in got)


def test_bounds_k_dims_allocate_nothing():
    """The pass reads deepseek_moe_16b's and zamba2_7b's full shapes from
    fake tensors: the process's memory does not grow by their weights."""
    import resource
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    dims = B._matmul_k_dims("deepseek_moe_16b") + B._matmul_k_dims("zamba2_7b")
    grew_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert ("layers/moe/w_down", 1408) in dims
    assert ("groups/mixer/out_proj", 7168) in dims
    assert grew_kb < 500_000                 # the fp32 params are ~95 GB


# ---------------------------------------------------------------------------
# kernel entry points refuse statically-unsafe shapes
# ---------------------------------------------------------------------------

def test_int8_matmul_refuses_overflowing_k():
    from repro_torch.kernels import ops
    k = 140_000                                   # 140000 * 127^2 >= 2^31
    x_q = torch.zeros((2, k), dtype=torch.int8)
    w_q = torch.zeros((k, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="RPR202"):
        ops.int8_matmul(x_q, w_q, torch.ones(2, 1), torch.ones(4))


def test_qmm_refuses_bad_shapes_with_diagnostics():
    import dataclasses
    from repro_torch.kernels.qmm import qmm
    from repro_torch.qtensor import quantize

    w = quantize(torch.ones((32, 16)), 4, group_size=8)
    x_q = torch.zeros((8, 32), dtype=torch.int8)
    xs = torch.ones((8, 1))
    with pytest.raises(ValueError, match="does not match k"):
        qmm(x_q[:, :16], w, xs)
    with pytest.raises(ValueError, match="do not divide"):
        qmm(x_q, dataclasses.replace(w, scale=w.scale[:3]), xs)
    with pytest.raises(ValueError, match="packed payload"):
        qmm(x_q, dataclasses.replace(w, data=w.data[:-1]), xs)


def test_allocate_act_sites_refuses_insane_problems():
    from repro_torch.core.fit import SensitivityReport
    from repro_torch.core.mpq import allocate_act_sites
    from repro_torch.quant.policy import QuantPolicy

    rep = SensitivityReport(
        weight_traces={}, act_traces={"s0": 1.0}, weight_ranges={},
        act_ranges={"s0": (-1.0, 1.0)}, param_sizes={})
    with pytest.raises(ValueError, match="budget_bits"):
        allocate_act_sites(rep, QuantPolicy(), float("inf"), [["s0"]], [64.0])
    with pytest.raises(ValueError, match="non-positive"):
        allocate_act_sites(rep, QuantPolicy(), 1024.0, [["s0"]],
                           [float("nan")])


# ---------------------------------------------------------------------------
# launch.roofline
# ---------------------------------------------------------------------------

def test_roofline_counts_and_flops_equal_reference():
    from repro.configs import SHAPES as J_SHAPES, get_config as j_get
    from repro.launch import roofline as J
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import roofline as R

    for arch in ARCH_IDS:
        assert R.param_counts(get_config(arch)) == J.param_counts(j_get(arch))
        for name, shape in SHAPES.items():
            got = R.model_flops(get_config(arch), shape)
            want = J.model_flops(j_get(arch), J_SHAPES[name])
            assert got == pytest.approx(want, rel=1e-12), (arch, name)


def test_roofline_terms_on_the_h100_peaks():
    from repro_torch.launch.roofline import RooflineTerms
    from repro_torch.obs.perf import cost

    t = RooflineTerms(flops_per_chip=989e12, bytes_per_chip=3.35e12 * 2,
                      link_traffic_per_chip=450e9 * 0.5, chips=2,
                      model_flops=989e12)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 0.5)
    assert t.bottleneck == "memory" and t.step_time_s == 2.0
    assert t.useful_ratio == 0.5
    assert t.mfu == pytest.approx(989e12 / (2 * cost.PEAK_FLOPS * 2.0))
    d = t.to_dict()
    assert d["bottleneck"] == "memory" and d["mfu"] == t.mfu
    assert set(d) == {"flops_per_chip", "bytes_per_chip",
                      "link_traffic_per_chip", "chips", "model_flops",
                      "compute_s", "memory_s", "collective_s", "bottleneck",
                      "step_time_s", "useful_ratio", "mfu"}
    assert RooflineTerms(0, 0, 0, 1, 1.0).mfu == 0.0


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------

def test_run_all_in_process_clean_on_cpu():
    """Every pass in process, the dispatch targets on the CPU: no error
    and no skipped target (the expert-parallel one runs); every engine
    variant's burst step ran and none of its ops synchronizes."""
    from repro_torch.analysis.dispatch_check import ENGINE_VARIANTS
    stats = {}
    rep = run_all(device="cpu", stats=stats)
    assert rep.exit_code() == 0, "\n".join(f.render() for f in rep.errors)
    assert [(f.code, f.severity, f.where) for f in rep.findings
            if f.severity == "info"] == []
    hot = sorted(name for name, st in stats.items() if st["hot"])
    assert len(hot) == 3 + len(ENGINE_VARIANTS)
    assert "engine[spec-paged].spec_step" in hot
    assert "engine[sharded].engine_step" in hot
    assert "engine[moe-ep].engine_step" in hot
    assert all(st["ops"] > 0 for st in stats.values())


def test_moe_ep_target_is_the_references_and_runs_clean():
    """``engine[moe-ep]`` is the reference checker's target: the deepseek
    smoke engine at W4 (group 8, int8_compute) on a two-shard tp mesh,
    its expert stacks planned "ep"; its burst step runs on the CPU with
    no finding and no synchronizing op."""
    from repro_torch.analysis import dispatch_check
    from repro_torch.launch.mesh import TPMesh
    eng = dispatch_check.smoke_engine("moe-ep", CPU)
    assert eng.cfg.name.startswith("deepseek") and eng.ecfg.int8_compute
    assert isinstance(eng.ecfg.mesh, TPMesh) and eng.ecfg.mesh.size == 2
    ep = sorted(k for k, v in eng._shard_plan.items() if v == "ep")
    assert ep and all(k.split("/")[-1] in ("w_up", "w_gate", "w_down") for k in ep)
    stats = {}
    found = dispatch_check.run(device=CPU, variants=("moe-ep",), stats=stats)
    assert [f for f in found if f.severity != "info"] == [], found
    assert stats["engine[moe-ep].engine_step"]["hot"]
    assert stats["engine[moe-ep].engine_step"]["ops"] > 0


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


def test_cli_lint_and_bounds_exit_zero():
    r = _cli("--lint", "--bounds", "--device", "cpu", "-q")
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "0 error(s)" in r.stdout and "WARNING" not in r.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a GPU")
def test_cli_dispatch_needs_a_gpu_unless_told_cpu():
    r = _cli("--dispatch")
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_engine_step_is_the_burst_without_its_fetch():
    """``Engine._burst`` is ``_engine_step`` plus the one host read: the
    step leaves its tokens on the device, and they are the tokens that
    ``Engine.run`` emits at the same positions of each stream."""
    from repro_torch.analysis.dispatch_check import smoke_engine, smoke_requests
    eng = smoke_engine("paged", CPU)
    reqs = smoke_requests(eng.cfg)
    fin, _ = eng.run(reqs)
    eng2 = smoke_engine("paged", CPU)
    eng2._start_run()
    with torch.no_grad():
        for r in smoke_requests(eng2.cfg):
            eng2._admit(r)
        eng2._grow_tables(2)
        n0 = eng2._nwritten.copy()
        ys = eng2._engine_step(2, "greedy", None)
    assert isinstance(ys, torch.Tensor) and ys.shape == (2, 2)
    assert ys.dtype == torch.int32
    assert [len(r.output_tokens) for r in fin] == [8, 8]
    n1 = np.minimum(n0 + 2, eng2._budget)
    assert np.array_equal(eng2._dnw.numpy(), n1)
    streams = {r.id: np.asarray(r.output_tokens) for r in fin}
    for b, r in enumerate(reqs):
        assert n1[b] > n0[b]
        np.testing.assert_array_equal(ys[:n1[b] - n0[b], b].numpy(),
                                      streams[r.id][n0[b]:n1[b]])
