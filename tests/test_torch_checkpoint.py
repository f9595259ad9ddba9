"""The port's checkpointer on the CPU: the reference's three checkpoint
contracts (round trip + LATEST + keep-gc, async save + shape guard, torn
save fallback), bf16 and QTensor trees bit for bit, the TrainState
layout, and checkpoints the reference's ``Checkpointer`` wrote (fp32
and bf16 leaves) restored by the port — the bf16 one the reference
cannot load itself."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.launch.steps import TrainState as JTrainState
from repro.optim.adamw import init_adam as j_init_adam
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.steps import TrainState
from repro_torch.optim.adamw import init_adam
from repro_torch.qtensor import QTensor, quantize
from _torch_threads import _one_thread  # noqa: F401


def test_checkpoint_roundtrip_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    ck.save(10, tree)
    ck.save(20, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}})
    assert ck.latest_step() == 20
    restored = ck.restore(20, tree)
    np.testing.assert_allclose(restored["a"].numpy(), tree["a"].numpy() * 2)
    assert restored["b"]["c"].dtype == torch.int32
    ck.save(30, tree)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000020", "step_00000030"]


def test_checkpoint_async_and_shape_guard(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.zeros((4, 4))}
    ck.save(1, tree, blocking=False)
    tree["a"].add_(1.0)                 # in place after the save returned
    ck.wait()
    assert ck.latest_step() == 1
    assert float(ck.restore(1, tree)["a"].sum()) == 0.0
    with pytest.raises(ValueError):
        ck.restore(1, {"a": torch.zeros((2, 2))})
    with pytest.raises(KeyError):
        ck.restore(1, {"b": torch.zeros((4, 4))})


def test_checkpoint_torn_save_recovery(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.zeros(3)}
    ck.save(1, tree)
    ck.save(2, tree)
    os.makedirs(tmp_path / "step_00000003")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_00000003")
    assert ck.latest_step() == 2


def test_bf16_train_state_round_trips_bit_for_bit(tmp_path):
    """A TrainState with bf16 params and fp32 moments: saved under the
    reference's leaf names (bf16 as 2-byte void arrays), restored bit for
    bit with each template leaf's dtype."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(16, 8, generator=g).to(torch.bfloat16),
              "layers": {"0": {"attn": {"wq": torch.randn(8, 8, generator=g)
                                        .to(torch.bfloat16)}}}}
    state = TrainState(params, init_adam(params))
    state.opt.m["embed"].normal_(generator=g)
    ck = Checkpointer(str(tmp_path))
    ck.save(5, state)
    man = json.load(open(tmp_path / "step_00000005" / "manifest.json"))
    assert man["keys"] == sorted(["params/embed", "params/layers/0/attn/wq",
                                  "opt/step", "opt/m/embed",
                                  "opt/m/layers/0/attn/wq", "opt/v/embed",
                                  "opt/v/layers/0/attn/wq"])
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as z:
        assert z["params/embed"].dtype == np.dtype("V2")
    zeros = TrainState({"embed": torch.zeros(16, 8, dtype=torch.bfloat16),
                        "layers": {"0": {"attn": {"wq": torch.zeros(
                            8, 8, dtype=torch.bfloat16)}}}},
                       init_adam(params))
    back = ck.restore(5, zeros)
    assert isinstance(back, TrainState)
    for a, b in ((state.params["embed"], back.params["embed"]),
                 (state.params["layers"]["0"]["attn"]["wq"],
                  back.params["layers"]["0"]["attn"]["wq"]),
                 (state.opt.m["embed"], back.opt.m["embed"])):
        assert b.dtype == a.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert back.opt.step.dtype == torch.int32


def test_qtensor_tree_round_trips(tmp_path):
    g = torch.Generator().manual_seed(1)
    tree = {"layers": {"0": {"attn": {"wq": quantize(torch.randn(64, 32, generator=g), 4,
                                                     group_size=16)}}},
            "head": quantize(torch.randn(32, 48, generator=g), 8),
            "final_norm": torch.ones(32, dtype=torch.bfloat16)}
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tree)
    man = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    assert man["qtensors"]["layers/0/attn/wq"] == {"bits": 4, "shape": [64, 32],
                                                   "axis": 0}
    assert "layers/0/attn/wq/0" in man["keys"] and "head/1" in man["keys"]
    back = ck.restore(3, tree)
    for path in (("layers", "0", "attn", "wq"), ("head",)):
        a, b = tree, back
        for k in path:
            a, b = a[k], b[k]
        assert isinstance(b, QTensor) and b.bits == a.bits and b.shape == a.shape
        assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
        assert torch.equal(a.dequantize(), b.dequantize())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_reference_checkpoints(tmp_path, dtype):
    """A reference TrainState checkpoint (its own ``Checkpointer``) restores
    into the port's TrainState with every value equal. The reference's own
    restore of the bf16 one fails (bf16 is saved as ``|V2`` void arrays
    that ``jnp.asarray`` refuses): a property of the reference (ROADMAP
    § C)."""
    rng = np.random.default_rng(2)
    jdt = jnp.dtype(dtype)
    jp = {"embed": jnp.asarray(rng.normal(size=(12, 8)), jdt),
          "layers": {"0": {"mlp": {"w_up": jnp.asarray(rng.normal(size=(8, 16)), jdt)}}}}
    jstate = JTrainState(jp, j_init_adam(jp))
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(7), m=jax.tree.map(lambda a: a + 0.5, jstate.opt.m)))
    JCheckpointer(str(tmp_path)).save(7, jstate)
    if dtype == "bfloat16":
        with pytest.raises(TypeError):
            JCheckpointer(str(tmp_path)).restore(7, jstate)
    tdt = getattr(torch, dtype)
    tp = {"embed": torch.zeros(12, 8, dtype=tdt),
          "layers": {"0": {"mlp": {"w_up": torch.zeros(8, 16, dtype=tdt)}}}}
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    back = ck.restore(7, TrainState(tp, init_adam(tp)))
    assert int(back.opt.step) == 7
    for path in (("embed",), ("layers", "0", "mlp", "w_up")):
        a, b = jp, back.params
        for k in path:
            a, b = a[k], b[k]
        assert b.dtype == tdt
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a.astype(jnp.float32)))
    np.testing.assert_array_equal(back.opt.m["embed"].numpy(),
                                  np.asarray(jstate.opt.m["embed"]))


def test_elastic_restore_across_meshes(tmp_path):
    """A tree sharded 8 ways over "data" is saved whole; restored with
    ``shardings=`` onto a (2, 2) ("data", "model") mesh under spec
    ("model", "data") its values are equal and each shard holds the
    slice the spec says (the reference's elastic scale-down). Without
    ``shardings`` restore returns plain tensors, as before."""
    from repro_torch.launch.mesh import NamedSharding, P, ShardedTensor, make_mesh, place
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mesh8 = make_mesh((8,), ("data",), device="cpu")
    sharded = place(tree, {"w": NamedSharding(mesh8, P("data", None))})
    assert sharded["w"].parts[(3,)].shape == (1, 8)
    ck = Checkpointer(str(tmp_path))
    ck.save(5, sharded)
    mesh4 = make_mesh((2, 2), ("data", "model"), device="cpu")
    restored = ck.restore(5, tree, {"w": NamedSharding(mesh4, P("model", "data"))})
    st = restored["w"]
    assert isinstance(st, ShardedTensor) and st.sharding.spec == P("model", "data")
    assert torch.equal(st.full(), tree["w"])
    for (d, m), part in st.parts.items():
        assert torch.equal(part, tree["w"][4 * m:4 * m + 4, 4 * d:4 * d + 4])
    plain = ck.restore(5, tree)
    assert torch.equal(plain["w"], tree["w"]) and not isinstance(plain["w"], ShardedTensor)


def test_reference_checkpoint_restores_onto_a_mesh(tmp_path):
    """A checkpoint the reference writes restores onto a port mesh: the
    TrainState's params laid out by the (2, 2) mesh's specs, the moments
    split further over "data" (ZeRO-1), every value equal."""
    from repro_torch.launch.mesh import NamedSharding, P, make_mesh
    from repro_torch.launch.steps import gather
    rng = np.random.default_rng(3)
    jp = {"embed": jnp.asarray(rng.normal(size=(12, 8)), jnp.float32),
          "w_up": jnp.asarray(rng.normal(size=(8, 16)), jnp.float32)}
    jstate = JTrainState(jp, j_init_adam(jp))
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(3), m=jax.tree.map(lambda a: a - 0.25, jstate.opt.m)))
    JCheckpointer(str(tmp_path)).save(3, jstate)
    tp = {"embed": torch.zeros(12, 8), "w_up": torch.zeros(8, 16)}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    p_sh = {"embed": NamedSharding(mesh, P(None, "model")),
            "w_up": NamedSharding(mesh, P(None, "model"))}
    m_sh = {"embed": NamedSharding(mesh, P("data", "model")),
            "w_up": NamedSharding(mesh, P("data", "model"))}
    opt_sh = type(init_adam(tp))(NamedSharding(mesh, P()), m_sh, m_sh)
    back = Checkpointer(str(tmp_path)).restore(
        3, TrainState(tp, init_adam(tp)), TrainState(p_sh, opt_sh))
    assert back.params["w_up"].parts[(1, 1)].shape == (8, 8)
    assert back.opt.m["embed"].parts[(1, 0)].shape == (6, 4)
    whole = gather(back)
    assert int(whole.opt.step) == 3
    for k in jp:
        np.testing.assert_array_equal(whole.params[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(whole.opt.m[k].numpy(),
                                      np.asarray(jstate.opt.m[k]))
