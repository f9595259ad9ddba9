"""The port's flash attention (the CPU route of the CUDA kernel, its plain
version) against the reference on the CPU: the JAX oracle in fp32 on
causal S == T, full S != T, causal S < T (the mask aligned bottom-right)
and ragged T; the Pallas kernel in interpret mode at the reference's own
kernel-test shapes and tolerance; causal S > T refused; and the model's
``chunked_attention`` on the same tensors. Then the head dims the card's
kernel takes through its width plan (any D up to 256, the split-head-dim
kernel in bf16/fp16 up to 512, and the wide kernel past that): the port
at the configurations' D = 12, 16, 96 and 112 and at D = 320 and 512
against the oracle and the Pallas kernel, the plan itself for every D
up to 1024 and every configuration, and the zero-padding and
split-head-dim arithmetic the card relies on. Inputs come from numpy with
a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (
    KERNEL_WIDTHS, SPLIT_WIDTHS, kernel_for, width_plan)
from repro_torch.models.attention import chunked_attention
from _torch_threads import _one_thread  # noqa: F401


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


# (S, T, causal): ragged causal S == T, ragged causal S < T (the mask
# aligned bottom-right), ragged full S != T
HEAD_DIM_SHAPES = [(77, 77, True), (30, 77, True), (50, 93, False)]


@pytest.mark.parametrize("d", (12, 16, 96, 112))
@pytest.mark.parametrize("s,t,causal", HEAD_DIM_SHAPES)
def test_any_head_dim_matches_jax_oracle_and_pallas(d, s, t, causal):
    """The configurations' head dims (smoke 12 and 16, phi3's 96,
    zamba2's 112) against the JAX oracle within 2e-6 (fp32), and against
    ``flash_attention_pallas`` in interpret mode within its 2e-3 where the
    two agree on the mask: its default blocks span S and T here (no
    unmasked padding), and it aligns a causal mask top-left, which is
    the oracle's mask only at S == T."""
    q, k, v = _qkv(d * 1000 + s + t, 2, 3, s, t, d)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal).numpy()
    oracle = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=causal))
    assert got.shape == (2, 3, s, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-6)
    if causal and s != t:
        return
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)


def _config_head_dims():
    dims = {}
    for arch in tconfigs.ARCH_IDS:
        for cfg in (tconfigs.get_config(arch), tconfigs.smoke_config(arch)):
            if cfg.head_dim:            # the ssm family has no attention
                dims[f"port {cfg.name}"] = cfg.head_dim
    for arch in jconfigs.ARCH_IDS:
        for cfg in (jconfigs.get_config(arch), jconfigs.smoke_config(arch)):
            if cfg.head_dim:
                dims[f"reference {cfg.name}"] = cfg.head_dim
    return dims


def test_width_plan_covers_every_head_dim():
    """The card's width plan as a pure function: every D from 1 to 256,
    in every dtype, runs at the least kernel width >= D, read in place
    exactly when a row is a whole number of 16-byte chunks; every head dim
    of every configuration (the port's and the reference's) has a width,
    phi3's 96 its own; past 256 the split-head-dim kernel takes bf16/fp16
    (``test_width_plan_past_256``) and the wide kernel fp32 at D itself,
    read in place; only D < 1 is refused."""
    for d in range(1, 257):
        for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2),
                             (torch.float16, 2)):
            width, padded = width_plan(d, dtype)
            assert width == min(w for w in KERNEL_WIDTHS if w >= d)
            assert padded == ((d * esize) % 16 != 0)
    dims = _config_head_dims()
    assert {12, 16, 64, 96, 112, 128} <= set(dims.values())
    for name, d in dims.items():
        assert width_plan(d, torch.bfloat16)[0] >= d, name
    assert width_plan(96, torch.bfloat16) == (96, False)
    assert width_plan(112, torch.bfloat16) == (128, False)
    assert width_plan(12, torch.bfloat16) == (32, True)
    for d in (257, 320, 512):
        assert width_plan(d, torch.float32) == (d, False)
        for dtype in (torch.bfloat16, torch.float16):
            assert width_plan(d, dtype) == (-(-d // 64) * 64, d % 8 != 0)
    with pytest.raises(ValueError, match="head dim"):
        width_plan(0, torch.bfloat16)


def test_width_plan_past_256():
    """Every D from 257 to 1024 in every dtype: bf16/fp16 up to 512 run
    the split-head-dim kernel at the least of its widths >= D (each half
    whole 32-column blocks), copied zero-padded exactly when a row is not
    a whole number of 16-byte chunks; fp32 runs ``f32_wide`` up to 512,
    and every dtype the wide CUDA-core kernel past 512, at D itself, read
    in place. Up to 256 the ``wgmma`` and ``f32`` kernels."""
    for d in range(257, 1025):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            width, padded = width_plan(d, dtype)
            kernel = kernel_for(width, dtype)
            if dtype != torch.float32 and d <= 512:
                assert width in SPLIT_WIDTHS and d <= width < d + 64
                assert padded == (d % 8 != 0) and kernel == "split"
            else:
                assert (width, padded) == (d, False)
                want = "f32_wide" if dtype == torch.float32 and d <= 512 else "wide"
                assert kernel == want
    for d in (12, 96, 256):
        assert kernel_for(width_plan(d, torch.bfloat16)[0], torch.bfloat16) == "wgmma"
        assert kernel_for(width_plan(d, torch.float32)[0], torch.float32) == "f32"


def _split_flash(q, k, v, causal):
    """The split-head-dim kernel's arithmetic, in float64 so that what
    the comparison sees is the algorithm and not fp32 rounding in another
    order (the card's own rounding is held to its tolerance by
    chip_smoke.py): q, k and v
    zero-padded to its width (the least of 320, 384, 448 and 512 >= D),
    each half's partial scores over 32-key tiles, S = S_0 + S_1, the
    online softmax with the scale 1/sqrt(D) of the true D and the causal
    mask aligned bottom-right, each half's O accumulated on its own, the
    halves concatenated and cut to D."""
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    width = width_plan(d, torch.bfloat16)[0]
    hw = width // 2
    q, k, v = (F.pad(x.double(), (0, width - d)) for x in (q, k, v))
    scale = 1.0 / d ** 0.5
    m = torch.full(q.shape[:3] + (1,), -torch.inf, dtype=torch.float64)
    den = torch.zeros(q.shape[:3] + (1,), dtype=torch.float64)
    halves = [torch.zeros(q.shape[:3] + (hw,), dtype=torch.float64)
              for _ in range(2)]
    rows = torch.arange(s).reshape(s, 1)
    for k0 in range(0, t, 32):
        part = [q[..., w * hw:(w + 1) * hw] @ k[..., k0:k0 + 32, w * hw:(w + 1) * hw]
                .transpose(-1, -2) for w in range(2)]
        sc = (part[0] + part[1]) * scale
        keys = torch.arange(k0, min(k0 + 32, t)).reshape(1, -1)
        if causal:
            sc = sc.masked_fill(keys > rows + t - s, -torch.inf)
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - mn), torch.exp(sc - mn)
        den = den * alpha + p.sum(-1, keepdim=True)
        for w in range(2):
            halves[w] = halves[w] * alpha + p @ v[..., k0:k0 + 32, w * hw:(w + 1) * hw]
        m = mn
    return (torch.cat(halves, -1) / den)[..., :d].float()


@pytest.mark.parametrize("d,s,t,causal", [(300, 64, 64, True),
                                          (512, 48, 80, False)])
def test_split_head_dim_arithmetic_matches_jax_oracle_and_pallas(d, s, t, causal):
    """The arithmetic the card's split-head-dim kernel relies on (S as
    the sum of the two half-width products on zero-padded inputs, O as
    the two halves concatenated) against the JAX oracle in fp32 within
    2e-6, and against ``flash_attention_pallas`` in interpret mode
    within its 2e-3: causal (S == T, where the two masks agree) at D =
    300 (20 zero columns) and full at D = 512 (the widest)."""
    q, k, v = _qkv(d * 7 + s + t, 1, 2, s, t, d)
    got = _split_flash(*(torch.from_numpy(x) for x in (q, k, v)), causal).numpy()
    oracle = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=causal))
    assert got.shape == (1, 2, s, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-6)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("d", (320, 512))
@pytest.mark.parametrize("s,t,causal", [(64, 64, True), (40, 96, True),
                                        (48, 80, False)])
def test_wide_head_dims_match_jax_oracle_and_pallas(d, s, t, causal):
    """Head dims past 256 (the card's split-head-dim kernel in bf16/fp16,
    its wide kernel in fp32; no configuration has one): the port's CPU route against the JAX oracle within 2e-6 (fp32),
    and against ``flash_attention_pallas`` in interpret mode within its
    2e-3 where the two agree on the mask (S == T when causal; its default
    blocks span S and T, so no padding goes unmasked)."""
    q, k, v = _qkv(d + s * 100 + t, 2, 2, s, t, d)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal).numpy()
    oracle = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=causal))
    assert got.shape == (2, 2, s, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-6)
    if causal and s != t:
        return
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("d", (12, 16, 96, 112, 200))
@pytest.mark.parametrize("causal", (True, False))
def test_zero_padding_to_the_width_keeps_the_first_d_columns(d, causal):
    """The arithmetic the card relies on: q, k and v zero-padded to the
    planned width, with the scale kept at 1/sqrt(D) of the true D, give
    the plain version's output on the first D columns within 2e-6 (fp32)
    and exact zeros past them."""
    s, t = (60, 60) if causal else (45, 70)
    q, k, v = (torch.from_numpy(a) for a in _qkv(d + s, 2, 3, s, t, d))
    width, _ = width_plan(d, torch.bfloat16)
    padded = [F.pad(x, (0, width - d)) for x in (q, k, v)]
    got = ref.flash_attention(*padded, causal=causal, scale=1.0 / d ** 0.5)
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.shape[-1] == width and not got[..., d:].any()
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(), rtol=0,
                               atol=2e-6)
