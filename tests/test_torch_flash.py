"""The port's flash attention (the CPU route of the CUDA kernel, its plain
version) against the reference on the CPU: the JAX oracle in fp32 on
causal S == T, full S != T, causal S < T (the mask aligned bottom-right)
and ragged T; the Pallas kernel in interpret mode at the reference's own
kernel-test shapes and tolerance; causal S > T refused; and the model's
``chunked_attention`` on the same tensors. Inputs come from numpy with
a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.models.attention import chunked_attention


def _qkv(seed, b, h, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, h, t, d)).astype(np.float32),
            rng.normal(size=(b, h, t, d)).astype(np.float32))


@pytest.mark.parametrize("s,t,causal", [
    (64, 64, True), (48, 80, False), (40, 96, True), (77, 77, True),
    (30, 77, True), (77, 300, False)])
def test_plain_flash_attention_matches_jax_oracle(s, t, causal):
    """fp32, tolerance 2e-6 absolute: the same fp32 softmax and products,
    summed in another order."""
    q, k, v = _qkv(s * 1000 + t, 2, 3, s, t, 32)
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=causal))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("s,t,causal", [(128, 128, True), (128, 128, False),
                                        (64, 256, False), (256, 256, True)])
def test_flash_attention_matches_pallas_interpret(s, t, causal):
    """``tests/test_kernels.py``'s flash cases (B=2, H=3, D=32, 64-row
    blocks) against ``flash_attention_pallas`` in interpret mode, within
    its 2e-3."""
    q, k, v = _qkv(0, 2, 3, s, t, 32)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=64, bkv=64, interpret=True))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_causal_s_greater_than_t_refused_reference_masks_disagree():
    """Reference properties (ROADMAP § C): for causal S > T the oracle
    (mask aligned bottom-right) returns NaN rows, and for causal S < T the
    Pallas kernel (mask aligned top-left) disagrees with it. The port
    refuses S > T and equals the oracle at S < T."""
    q, k, v = _qkv(1, 1, 2, 96, 64, 32)
    nan_rows = np.asarray(jref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    assert np.isnan(nan_rows).any()
    with pytest.raises(ValueError, match="S=96 > T=64"):
        ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True)

    q, k, v = _qkv(2, 1, 2, 64, 128, 32)
    oracle = np.asarray(jref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        bq=64, bkv=64, interpret=True))
    assert np.abs(pallas - oracle).max() > 0.1
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=2e-6)


def test_flash_attention_refuses_mismatched_inputs():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.to(torch.bfloat16), q.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_equals_chunked_attention(dtype):
    """The model's own attention (``chunked_attention``, (B, S, H, D)
    layout, 32-key chunks) and ``ops.flash_attention`` on the same causal
    tensors: fp32 within 2e-6; bf16 within 2e-2 absolute — both round P
    to bf16 (the chunked version per 32-key chunk, unnormalized against
    its running max) and their outputs to bf16, in other orders."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(3, 2, 4, 96, 96, 32))
    want = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True, chunk=32)
    got = ops.flash_attention(q, k, v, causal=True)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               want.transpose(1, 2).float().numpy(),
                               rtol=0, atol=tol)
