"""The dry run's meta runs against the same steps on real CPU tensors:
for every smoke config, the (2,4) train, prefill and w8kv8 decode steps
run once on ``meta`` (``launch.dryrun._analyze``) and once on a CPU mesh
from seeded params and inputs under ``FlopCounterMode`` and the mesh's
collective recorder. The FLOPs, the collective ledger (bytes, traffic
and counts by kind) and the output shapes and dtypes must be equal: a
meta route computes nothing but must take every shape the real route
takes. The recurrent families' mesh decode (R9) also gives the same
greedy tokens on (2,4) as on (1,1)."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, ShapeSpec, smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import ShardOptions
from repro_torch.models.decode import init_decode_state
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import init_adam
from repro_torch.utils.hlo import CollectiveStats
from _torch_threads import _one_thread  # noqa: F401

AXES = ("data", "model")
B, S = 4, 16
KINDS = {"train": ShardOptions(), "prefill": ShardOptions(),
         "decode": ShardOptions(decode_quant="w8kv8")}


def _inputs(cfg, kind, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, m in tsteps.input_specs(cfg, ShapeSpec("s", S, B, kind)).items():
        if m.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(0, cfg.vocab_size, tuple(m.shape))
                                      .astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.normal(size=tuple(m.shape))
                                      .astype(np.float32)).to(m.dtype)
    return out


def _real_args(cfg, kind, params):
    inputs = _inputs(cfg, kind)
    if kind == "train":
        return (tsteps.TrainState(params, init_adam(params)), inputs)
    if kind == "prefill":
        inputs.pop("labels", None)
        return (params, inputs)
    qp, _ = tsteps.quantize_decode_params(params, cfg)
    state = init_decode_state(cfg, B, S, device="cpu", kv_dtype=torch.int8)
    return (qp, state, inputs["tokens"])


def _real_run(cfg, kind, mesh_shape, params):
    mesh = Mesh.on_device(mesh_shape, AXES, "cpu")
    build = tsteps.build_step(cfg, ShapeSpec("s", S, B, kind), mesh, KINDS[kind])
    stats = CollectiveStats()
    flops = FlopCounterMode(display=False)
    with mesh.recording(stats), flops:
        out = build.fn(*_real_args(cfg, kind, params))
    return out, stats, flops.get_total_flops()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_run_matches_real_cpu_run(arch):
    """Each step kind's meta run on (2,4): FLOPs, ledger and output
    shapes equal to the real CPU run's. The meta decode of every family
    takes ``paged_attention``'s meta route or the cache's torch ops, as
    the real one takes the plain route."""
    cfg = smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    for kind, opts in KINDS.items():
        shape = ShapeSpec("s", S, B, kind)
        meta = dr._analyze(dr._lower(cfg, shape, Mesh.on_device((2, 4), AXES, "meta"),
                                     opts))
        out, stats, flops = _real_run(cfg, kind, (2, 4), params)
        assert meta["totals"]["flops"] == flops > 0, kind
        assert meta["coll"].bytes_by_kind == stats.bytes_by_kind, kind
        assert meta["coll"].traffic_by_kind == stats.traffic_by_kind, kind
        assert meta["collective_counts"] == stats.count_by_kind, kind
        assert meta["output_shapes"] == dr._shapes(out), kind
        if kind == "decode" and cfg.family in ("ssm", "hybrid"):
            tok = {}
            for ms in ((1, 1), (2, 4)):
                logits = _real_run(cfg, kind, ms, params)[0][0].full()
                tok[ms] = torch.argmax(logits[:, -1], -1).tolist()
            assert tok[(2, 4)] == tok[(1, 1)]
