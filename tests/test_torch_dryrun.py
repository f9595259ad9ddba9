"""The shape-only dry run (``repro_torch.launch.dryrun``) and the HLO text
parser (``repro_torch.utils.hlo``) against the reference.

The reference's side runs in one subprocess with 8 forced host devices
(as ``tests/test_distributed.py`` runs its mesh tests): it compiles the
llama3_8b smoke (2,4) train, prefill and w8kv8 decode steps and writes
their HLO text and cost analysis, its ``_cost_pair`` for every config ×
shape × chunk, and its ``run_cell`` result (a (2,4) mesh and the smoke
decode patched in) with the file name ``save_result`` gives it. The
parser must return what the reference's returns on the same text, field
for field; the dry run must give the reference's configs, keys and file
names. The meta runs are held against real CPU runs of the same steps
in ``tests/test_torch_dryrun_steps.py``."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.utils import hlo as jhlo
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, smoke_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import ShardOptions
from repro_torch.utils import hlo as thlo
from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")

REFERENCE_SIDE = """
import dataclasses, json, os, sys
import jax
from repro.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, smoke_config
from repro.launch.mesh import make_mesh
from repro.launch.sharding import ShardOptions
from repro.launch.steps import build_step
from repro.utils.hlo import cost_analysis_dict
import repro.launch.dryrun as rd

out = {"steps": {}, "pairs": {}}
cfg = smoke_config("llama3_8b")
mesh = make_mesh((2, 4), ("data", "model"))
for kind, shape in (("train", ShapeSpec("t", 64, 4, "train")),
                    ("prefill", ShapeSpec("p", 64, 4, "prefill")),
                    ("decode", ShapeSpec("d", 64, 4, "decode"))):
    b = build_step(cfg, shape, mesh,
                   ShardOptions(decode_quant="w8kv8" if kind == "decode" else None))
    c = b.fn.lower(*b.args).compile()
    out["steps"][kind] = {"hlo": c.as_text(),
                          "cost": {k: float(v) for k, v in cost_analysis_dict(c).items()}}
for a in ARCH_IDS:
    for s, shape in SHAPES.items():
        for chunk in (None, shape.seq_len):
            c1, c2, m = rd._cost_pair(get_config(a), shape, chunk=chunk)
            out["pairs"][f"{a}/{s}/{chunk}"] = [dataclasses.asdict(c1),
                                                dataclasses.asdict(c2), m]
rd.make_production_mesh = lambda multi_pod=False: mesh
rd.get_config = smoke_config
rd.SHAPES = {"decode_32k": ShapeSpec("decode_32k", 64, 4, "decode")}
res = rd.run_cell("llama3_8b", "decode_32k")
out["cell"] = json.loads(json.dumps(res, default=str))
out["file"] = os.path.basename(rd.save_result(res, sys.argv[2]))
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_dryrun")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.setdefault("REPRO_KERNELS", "ref")
    path = tmp / "ref.json"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_SIDE),
                        str(path), str(tmp)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# (i) the HLO text parser
# ---------------------------------------------------------------------------

SYNTHETIC_HLO = """\
HloModule synthetic, entry_computation_layout={(f32[16]{0})->f32[16]{0}}

%add.1 (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %x, f32[] %y)
}

%body.7 (p.1: (s32[], f32[8])) -> (s32[], f32[8]) {
  %p.1 = (s32[], f32[8]{0}) parameter(0)
  %g = f32[8]{0} get-tuple-element((s32[], f32[8]{0}) %p.1), index=1
  %ar.2 = f32[8]{0} all-reduce(f32[8]{0} %g), channel_id=3, replica_groups=[2,4]<=[8], to_apply=%add.1
  %ags = (bf16[4,8]{1,0}, bf16[16,8]{1,0}) all-gather-start(bf16[4,8]{1,0} %h), channel_id=4, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %agd = bf16[16,8]{1,0} all-gather-done((bf16[4,8]{1,0}, bf16[16,8]{1,0}) %ags)
  ROOT %t = (s32[], f32[8]{0}) tuple(s32[] %i, f32[8]{0} %ar.2)
}

%cond.7 (p.2: (s32[], f32[8])) -> pred[] {
  %p.2 = (s32[], f32[8]{0}) parameter(0)
  %cp.9 = f32[8]{0} collective-permute(f32[8]{0} %q), source_target_pairs={{0,1},{1,0}}
  ROOT %lt = pred[] compare(s32[] %i, s32[] %n), direction=LT
}

ENTRY %main.9 (a.1: f32[16]) -> f32[16] {
  %a.1 = f32[16]{0} parameter(0)
  %rs = s4[64]{0} reduce-scatter(s4[256]{0} %b), channel_id=1, replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add.1
  %a2a = (f32[2,8]{1,0}, u32[]) all-to-all(f32[2,8]{1,0} %c, u32[] %d), channel_id=2, replica_groups=[1,8]<=[8]
  %cps = (f32[16]{0}, f32[16]{0}) collective-permute-start(f32[16]{0} %a.1), source_target_pairs={{0,1}}
  %cpd = f32[16]{0} collective-permute-done((f32[16]{0}, f32[16]{0}) %cps)
  %ar.1 = f32[16]{0} all-reduce(f32[16]{0} %a.1), replica_groups={}, to_apply=%add.1
  %w = (s32[], f32[8]{0}) while((s32[], f32[8]{0}) %init), condition=%cond.7, body=%body.7
  ROOT %r = f32[16]{0} add(f32[16]{0} %cpd, f32[16]{0} %ar.1)
}
"""

PARSER_CASES = [
    {},
    {"while_trip_counts": {"body": 5.0}},
    {"while_trip_counts": {"nomatch": 9.0}, "default_trip_count": 3.0},
    {"f32_as_bf16": True, "while_trip_counts": {"body.7": 2.0}},
]
OPS = ("all-reduce", "all-gather-start", "all-gather", "while", "add",
       "fusion", "dot", "collective-permute-done")


def _stats(s):
    return (s.bytes_by_kind, s.traffic_by_kind, s.count_by_kind)


def _same_text_analysis(text):
    assert thlo._split_computations(text) == jhlo._split_computations(text)
    for kw in PARSER_CASES:
        got = thlo.collective_bytes(text, **kw)
        want = jhlo.collective_bytes(text, **kw)
        assert dataclasses.fields(got) == dataclasses.fields(thlo.CollectiveStats)
        assert _stats(got) == _stats(want), kw
        assert (got.total_bytes, got.total_traffic) == (want.total_bytes,
                                                         want.total_traffic)
    for op in OPS:
        assert thlo.count_op(text, op) == jhlo.count_op(text, op), op


def test_parser_matches_reference_on_synthetic_hlo():
    """Tuples, ``s4``, ``-start``/``-done`` pairs (the done half skipped),
    iota and list ``replica_groups``, a while body scaled by
    ``while_trip_counts`` (and its condition not): the port's parser
    equals the reference's, and a few totals pinned by hand."""
    _same_text_analysis(SYNTHETIC_HLO)
    for name in ("add.1", "body.7", "cond.7", "main.9"):
        assert name in thlo._split_computations(SYNTHETIC_HLO)
    s = thlo.collective_bytes(SYNTHETIC_HLO, while_trip_counts={"body": 5.0})
    # the body's all-reduce 32 B x 5 and the entry's 64 B (groups {} -> 0,
    # one entry each); the gather start's tuple 64 + 256 B x 5
    assert s.bytes_by_kind["all-reduce"] == 32 * 5 + 64
    assert s.bytes_by_kind["all-gather"] == (64 + 256) * 5
    assert s.bytes_by_kind["reduce-scatter"] == 32            # s4: two a byte
    assert s.count_by_kind["collective-permute"] == 2         # cond's + start
    assert thlo.shape_bytes("(f32[2,8]{1,0}, u32[])") == 68


class _Compiled:
    def __init__(self, cost):
        self.cost = cost

    def cost_analysis(self):
        return self.cost


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_parser_matches_reference_on_compiled_steps(reference, kind):
    """The reference's compiled (2,4) smoke steps' HLO text: every parser
    function equal to the reference's on it; ``cost_analysis_dict`` on
    its cost analysis as a dict, a one-element list and an empty list."""
    step = reference["steps"][kind]
    text = step["hlo"]
    _same_text_analysis(text)
    assert thlo.collective_bytes(text).total_bytes > 0
    for form in (step["cost"], [step["cost"]], []):
        got = thlo.cost_analysis_dict(_Compiled(form))
        assert got == jhlo.cost_analysis_dict(_Compiled(form))
    assert thlo.cost_analysis_dict(_Compiled([step["cost"]]))["flops"] > 0


# ---------------------------------------------------------------------------
# (ii) the cost pair
# ---------------------------------------------------------------------------

def test_cost_pair_matches_reference(reference):
    """``_cost_pair`` equals the reference's for every config × shape,
    with and without ``chunk``: both configs field for field and the
    multiplier (the hybrid's period + remainder)."""
    n = 0
    for a in ARCH_IDS:
        for s, shape in SHAPES.items():
            for chunk in (None, shape.seq_len):
                c1, c2, m = dr._cost_pair(get_config(a), shape, chunk=chunk)
                w1, w2, wm = reference["pairs"][f"{a}/{s}/{chunk}"]
                got = [dataclasses.asdict(c1), dataclasses.asdict(c2)]
                for g, w in zip(got, (w1, w2)):
                    g["skip_shapes"] = list(g["skip_shapes"])
                    assert g == w, (a, s, chunk)
                assert m == wm
                n += 1
    assert n == len(ARCH_IDS) * len(SHAPES) * 2


def _meta(shape):
    return Mesh.on_device(shape, AXES, "meta")


def _analyze(cfg, shape, mesh_shape, opts=ShardOptions()):
    return dr._analyze(dr._lower(cfg, shape, _meta(mesh_shape), opts))


def test_flops_pair_not_needed():
    """The port's chunked attention counts every chunk: a prefill and a
    train step at seq 64 > attn_chunk 16 count the same FLOPs at
    ``chunk=seq_len`` as at the real chunk, at both pair depths (so
    ``run_cell`` keeps no second FLOPs pair)."""
    cfg = dataclasses.replace(smoke_config("llama3_8b"), attn_chunk=16)
    for kind in ("prefill", "train"):
        shape = ShapeSpec("s", 64, 4, kind)
        pairs = [dr._cost_pair(cfg, shape), dr._cost_pair(cfg, shape, chunk=64)]
        assert pairs[0][0].attn_chunk == 16 and pairs[1][0].attn_chunk == 64
        for real, whole in zip(pairs[0][:2], pairs[1][:2]):
            assert _analyze(real, shape, (1, 2))["flops"] == \
                _analyze(whole, shape, (1, 2))["flops"]


# ---------------------------------------------------------------------------
# (iv) attribution, (v) extrapolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_attribution_one_shard_is_the_total(kind):
    """On a (1,1) mesh a chip is the mesh: per-chip FLOPs, bytes and temp
    equal the run's totals, the arguments' bytes equal every argument's
    whole bytes, and one card needs arguments + the run's temp."""
    cfg = smoke_config("internlm2_1_8b")
    build = dr._lower(cfg, ShapeSpec("s", 32, 4, kind), _meta((1, 1)),
                      ShardOptions(decode_quant="w8kv8" if kind == "decode" else None))
    a = dr._analyze(build)
    assert a["flops"] == a["totals"]["flops"] > 0
    assert a["bytes"] == a["totals"]["bytes"] > 0
    assert a["mem"]["temp_bytes"] == a["totals"]["temp_bytes_run"] > 0
    whole = sum(t.numel() * t.element_size() for t in _leaves(build.args))
    assert a["mem"]["argument_bytes"] == whole
    assert dr.one_card_bytes(build, a["totals"]["temp_bytes_run"]) == \
        whole + a["totals"]["temp_bytes_run"]
    if kind != "prefill":                   # the state is updated in place
        assert 0 < a["mem"]["alias_bytes"] <= a["mem"]["output_bytes"]


def _leaves(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch,kind", [("llama3_8b", "train"), ("olmoe_1b_7b", "train"),
                                       ("mamba2_130m", "decode"),
                                       ("internlm2_1_8b", "prefill")])
def test_pair_extrapolation_against_full_depth(monkeypatch, arch, kind):
    """At smoke width and 4 layers on a (2,4) mesh: the pair's
    extrapolation equals the full-depth run exactly in FLOPs, bytes, the
    ledger (bytes, traffic, counts) and the argument, output and alias
    bytes. The temp peak does not extrapolate (it moves with depth), so
    ``run_cell`` reports the full-depth run's memory."""
    shape = ShapeSpec("s", 32, 4, kind)
    _patch_cli(monkeypatch, shapes={"s": shape})
    monkeypatch.setattr(dr, "get_config",
                        lambda a: dataclasses.replace(smoke_config(a), num_layers=4))
    opts = ShardOptions(decode_quant="w8kv8" if kind == "decode" else None)
    res = dr.run_cell(arch, "s", opts=opts)
    ext, full = res["extrapolated"], res["full_module"]
    assert res["shape_only"]["mult"] == 2.0
    assert ext["flops_per_chip"] == full["flops_per_chip_raw"] > 0
    assert ext["bytes_per_chip"] == full["bytes_per_chip_raw"] > 0
    assert ext["collective_bytes"] == full["collective_bytes_raw"]
    assert ext["collective_traffic_per_chip"] == full["collective_traffic_raw"]
    a = dr._analyze(dr._lower(dr.get_config(arch), shape, _meta((2, 4)), opts))
    assert res["memory"] == a["mem"] and a["mem"]["temp_bytes"] > 0
    assert full["collective_counts"] == a["collective_counts"]


@pytest.mark.parametrize("arch,kind", [("internlm2_1_8b", "train"),
                                       ("internlm2_1_8b", "prefill"),
                                       ("internlm2_1_8b", "decode"),
                                       ("mamba2_130m", "train"),
                                       ("olmoe_1b_7b", "decode")])
def test_temp_per_chip_fixed_under_the_data_axis(arch, kind):
    """At a fixed batch a row, (1,4) -> (2,4) leaves the origin shard's
    ``temp_bytes`` as it is, while the run's undivided peak grows with
    the rows it keeps (the gradients). Prefill and decode hold nothing
    across rows: equal to the byte. A train step's all-reduce over a
    data axis of 2 folds through one more live intermediate than a data
    axis of 1 (one ``add`` of a gradient part before the mean): within
    1%."""
    got = []
    for d in (1, 2):
        shape = ShapeSpec("s", 32, 2 * d, kind)
        build = dr._lower(smoke_config(arch), shape, _meta((d, 4)),
                          ShardOptions(decode_quant="w8kv8" if kind == "decode" else None))
        got.append(dr._analyze(build))
    t1, t2 = (a["mem"]["temp_bytes"] for a in got)
    if kind == "train":
        assert got[1]["totals"]["temp_bytes_run"] > got[0]["totals"]["temp_bytes_run"]
        assert t2 > got[1]["totals"]["temp_bytes_run"] / 8
        assert abs(t2 - t1) <= 0.01 * t1
    else:
        assert t2 == t1 > 0


# ---------------------------------------------------------------------------
# (vi) run_cell, (vii) main
# ---------------------------------------------------------------------------

def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("roofline", "param_counts"):
            out |= _keys(v, prefix + k + "/")
    return out


def _patch_cli(monkeypatch, mesh_shape=(2, 4), shapes=None):
    """Smoke configs, a small shape and a (2,4) meta mesh ((2,2,4) with
    ``multi_pod``) in place of the production ones."""
    monkeypatch.setattr(dr, "get_config", smoke_config)
    monkeypatch.setattr(dr, "meta_mesh", lambda multi_pod=False: Mesh.on_device(
        (2,) + tuple(mesh_shape), ("pod",) + AXES, "meta") if multi_pod
        else _meta(mesh_shape))
    monkeypatch.setattr(dr, "SHAPES", shapes or {
        "decode_32k": ShapeSpec("decode_32k", 64, 4, "decode")})


def test_run_cell_keys_and_hbm(reference, monkeypatch):
    """``run_cell`` on the llama3_8b smoke decode at (2,4): the
    reference's keys (its ``run_cell`` on the same cell, in the
    subprocess), ``roofline`` as ``RooflineTerms.to_dict`` with the H100
    peaks, ``param_counts`` the reference's, and ``hbm_per_device_gib``
    = argument + temp + output − alias."""
    _patch_cli(monkeypatch)
    res = dr.run_cell("llama3_8b", "decode_32k", opts=ShardOptions())
    want = reference["cell"]
    assert _keys(want) <= _keys(res)
    assert set(res) - set(want) == {"shape_only"}
    assert res["param_counts"] == want["param_counts"]
    assert res["roofline"]["chips"] == want["roofline"]["chips"] == 8
    m = res["memory"]
    assert res["hbm_per_device_gib"] == round(
        (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
         - m["alias_bytes"]) / 2 ** 30, 3)
    assert res["status"] == "ok" and res["compile_s"] >= 0
    assert res["roofline"]["model_flops"] == want["roofline"]["model_flops"]


def test_main_writes_reference_file_names(reference, monkeypatch, tmp_path, capsys):
    """``main`` writes the reference's file name (16x16, and 2x16x16 with
    ``--multi-pod``); ``--skip-existing`` skips it; ``--all`` records a
    failed cell as ``status: "failed"`` and exits 1."""
    _patch_cli(monkeypatch)
    dr.main(["--arch", "llama3_8b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == [reference["file"]]
    assert reference["file"] == "llama3_8b__decode_32k__16x16__baseline.json"
    got = json.loads((tmp_path / reference["file"]).read_text())
    assert got["status"] == "ok" and got["mesh"] == "16x16"
    dr.main(["--arch", "llama3_8b", "--shape", "decode_32k", "--multi-pod",
             "--skip-existing", "--out", str(tmp_path)])
    multi = tmp_path / "llama3_8b__decode_32k__2x16x16__baseline.json"
    assert json.loads(multi.read_text())["chips"] == 16
    real = dr.run_cell
    monkeypatch.setattr(dr, "ARCH_IDS", ["llama3_8b", "mamba2_130m"])

    def flaky(arch, *a, **kw):
        if arch == "mamba2_130m":
            raise RuntimeError("planted failure")
        return real(arch, *a, **kw)

    monkeypatch.setattr(dr, "run_cell", flaky)
    with pytest.raises(SystemExit) as e:
        dr.main(["--all", "--skip-existing", "--out", str(tmp_path)])
    assert e.value.code == 1
    failed = json.loads((tmp_path / "mamba2_130m__decode_32k__16x16__baseline.json")
                        .read_text())
    assert failed["status"] == "failed" and "planted failure" in failed["error"]


# ---------------------------------------------------------------------------
# (viii) the meta routes, and the dry run refuses real tensors
# ---------------------------------------------------------------------------

def _paged_inputs(device, bits):
    g = torch.Generator().manual_seed(0)
    b, kvh, grp, dh, pages, page = 3, 2, 2, 16, 6, 4
    q = torch.randn(b, kvh, grp, dh, generator=g)
    if bits == 16:
        kp = torch.randn(pages, page, kvh, dh, generator=g)
        vp = torch.randn(pages, page, kvh, dh, generator=g)
        ks = vs = None
    else:
        kp = torch.randint(-127, 128, (pages, page, kvh, dh), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (pages, page, kvh, dh), generator=g,
                           dtype=torch.int8)
        ks = torch.rand(pages, kvh, generator=g)
        vs = torch.rand(pages, kvh, generator=g)
    table = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    lengths = torch.tensor([1, 5, 8], dtype=torch.int32)
    move = (lambda t: t if t is None else t.to(device))
    return [move(t) for t in (q, kp, vp, table, lengths, ks, vs)]


@pytest.mark.parametrize("bits", [16, 8])
def test_paged_attention_meta_route(bits):
    """``paged_attention`` on meta tensors: the CPU route's output shape
    and dtype, nothing launched, the kernel's checks (a bad q dtype or
    missing scales raise), and meta mixed with CPU tensors raises."""
    q, kp, vp, table, lengths, ks, vs = _paged_inputs("cpu", bits)
    want = pa.paged_attention(q, kp, vp, table, lengths, ks, vs, bits=bits)
    mq, mkp, mvp, mt, ml, mks, mvs = _paged_inputs("meta", bits)
    before = pa.launches
    got = pa.paged_attention(mq, mkp, mvp, mt, ml, mks, mvs, bits=bits)
    assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert pa.launches == before
    with pytest.raises(ValueError, match="q dtype"):
        pa.paged_attention(mq.to(torch.float16), mkp, mvp, mt, ml, mks, mvs, bits=bits)
    if bits < 16:
        with pytest.raises(ValueError, match="scale"):
            pa.paged_attention(mq, mkp, mvp, mt, ml, None, None, bits=bits)
    with pytest.raises(ValueError, match="mixed"):
        pa.paged_attention(mq, kp, vp, table, lengths, ks, vs, bits=bits)
    with pytest.raises(ValueError, match="mixed"):
        pa.paged_attention(q, mkp, mvp, mt, ml, mks, mvs, bits=bits)


def test_dry_run_refuses_real_tensors():
    """The dry run takes a meta mesh and meta stand-ins only, and an op
    that makes a real tensor inside it raises."""
    cfg = smoke_config("llama3_8b")
    shape = ShapeSpec("s", 16, 2, "prefill")
    with pytest.raises(ValueError, match="meta"):
        dr._lower(cfg, shape, Mesh.on_device((1, 1), AXES, "cpu"), ShardOptions())
    build = dr._lower(cfg, shape, _meta((1, 1)), ShardOptions())
    real = dataclasses.replace(build, args=(build.args[0], {
        "tokens": torch.zeros((2, 16), dtype=torch.int32)}))
    with pytest.raises(ValueError, match="meta stand-ins"):
        dr._analyze(real)
    ledger = dr._Ledger()
    with pytest.raises(RuntimeError, match="dry run"):
        with ledger:
            torch.ones(2) + 1
    ledger.close()
