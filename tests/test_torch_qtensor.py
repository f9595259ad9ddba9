"""repro_torch.qtensor against repro.qtensor: payloads and scales are
byte-identical at every width x group size x axis."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import qtensor as jq
from repro_torch import qtensor as tq
from _torch_threads import _one_thread  # noqa: F401


BITS = (8, 7, 6, 5, 4, 3)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("group_size", [None, 4, 12])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_byte_identical(bits, group_size, axis):
    rng = np.random.default_rng(bits * 100 + (group_size or 0) + axis)
    x = rng.normal(size=(24, 36, 5)).astype(np.float32)
    a = jq.quantize(jnp.asarray(x), bits, group_size=group_size, axis=axis)
    b = tq.quantize(torch.from_numpy(x), bits, group_size=group_size, axis=axis)
    assert b.data.dtype == (torch.uint8 if bits in (6, 4, 3) else torch.int8)
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    assert (b.bits, b.shape, b.axis) == (a.bits, a.shape, a.axis)
    np.testing.assert_array_equal(b.unpack().numpy(), np.asarray(a.unpack()))
    np.testing.assert_array_equal(b.dequantize().numpy(),
                                  np.asarray(a.dequantize()))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_unpack_identical(bits, axis):
    rng = np.random.default_rng(bits)
    qm = int(jq.qmax_for_bits(bits))
    q = rng.integers(-qm, qm + 1, size=(12, 8, 16)).astype(np.int8)
    pj = np.asarray(jq.pack(jnp.asarray(q), bits, axis=axis))
    pt = tq.pack(torch.from_numpy(q), bits, axis=axis)
    np.testing.assert_array_equal(pt.numpy(), pj)
    size = q.shape[axis]
    np.testing.assert_array_equal(tq.unpack(pt, bits, size, axis=axis).numpy(), q)
    if axis == 0 and q.ndim == 3:
        p2 = tq.pack(torch.from_numpy(q[:, :, 0]), bits, axis=0)
        np.testing.assert_array_equal(
            tq.unpack_rows(p2, bits).numpy(),
            np.asarray(jq.unpack_rows(jnp.asarray(p2.numpy()), bits))
            if bits in (6, 4, 3) else q[:, :, 0])


def test_storage_summary_and_payload_bytes_equal():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    jt = {"a": jq.quantize(jnp.asarray(x), 4, group_size=8),
          "b": jq.quantize(jnp.asarray(x), 6), "c": jnp.asarray(x[0])}
    tt = {"a": tq.quantize(torch.from_numpy(x), 4, group_size=8),
          "b": tq.quantize(torch.from_numpy(x), 6), "c": torch.from_numpy(x[0])}
    assert tq.storage_summary(tt) == jq.storage_summary(jt)
    assert tq.tree_payload_bytes(tt) == jq.tree_payload_bytes(jt)
    assert tq.tree_has_qtensor(tt) and not tq.tree_has_qtensor({"c": tt["c"]})


@pytest.mark.parametrize("bits", (16, 8, 6, 4, 3))
def test_size_helpers(bits):
    for n in (4, 12, 128):
        assert tq.packed_size(n, bits) == jq.packed_size(n, bits)
        assert tq.logical_size(tq.packed_size(n, bits), bits) == \
            jq.logical_size(jq.packed_size(n, bits), bits)
    assert tq.bytes_per_element(bits) == jq.bytes_per_element(bits)
    assert tq.qmax_for_bits(bits) == jq.qmax_for_bits(bits)


def test_quantize_rejects_bad_groups():
    x = torch.zeros((12, 4))
    with pytest.raises(ValueError):
        tq.quantize(x, 4, group_size=5)
    with pytest.raises(ValueError):
        tq.quantize(x, 6, group_size=6)
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(8), 8)
