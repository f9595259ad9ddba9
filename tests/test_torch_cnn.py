"""The paper's own testbed in the port against the reference: the
synthetic classification and segmentation datasets (bit for bit), the
CNN (with and without batch-norm) and the U-Net (forward, loss, tap
shapes and activation sites, EF traces through ``build_report`` on tuple
batches, mIoU), and, from the reference's trained CNN, FIT and the QAT
loss of the same random mixed-precision configs: the paper's Table-2
protocol, Spearman of FIT against the loss change."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_report as j_build, sample_configs as j_sample
from repro.core.rankcorr import spearman as j_spearman
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn, unet as junet
from repro.models.context import QATContext as JQAT
from repro.quant.policy import QuantPolicy as JPolicy
from repro_torch.convert import bit_config_from_reference, params_from_numpy
from repro_torch.core import build_report as t_build, sample_configs as t_sample
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.rankcorr import spearman as t_spearman
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn, unet as tunet
from repro_torch.models.context import QATContext as TQAT
from repro_torch.quant.policy import QuantPolicy as TPolicy
from _torch_threads import _one_thread  # noqa: F401


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tt(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _jj(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("kw", [dict(), dict(input_hw=8, num_classes=4, seed=1),
                                dict(channels=1, label_noise=0.2, seed=3)])
def test_classify_dataset_bit_equal(kw):
    want = jsyn.classify_dataset(jsyn.ClassifyConfig(**kw), 96, split_seed=7)
    got = tsyn.classify_dataset(tsyn.ClassifyConfig(**kw), 96, split_seed=7)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(), dict(input_hw=16, max_shapes=5, seed=2)])
def test_segment_dataset_and_batches_bit_equal(kw):
    want = jsyn.segment_dataset(jsyn.SegmentConfig(**kw), 12, split_seed=1)
    got = tsyn.segment_dataset(tsyn.SegmentConfig(**kw), 12, split_seed=1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    jb = list(jsyn.batched(*want, 5, seed=4, epochs=2))
    tb = list(tsyn.batched(*got, 5, seed=4, epochs=2))
    assert len(tb) == len(jb) == 4
    for (gx, gy), (wx, wy) in zip(tb, jb):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.fixture(scope="module")
def cnn_data():
    dcfg = jsyn.ClassifyConfig(input_hw=8, num_classes=4, seed=1)
    return jsyn.classify_dataset(dcfg, 64)


@pytest.mark.parametrize("batchnorm", [True, False])
def test_cnn_forward_loss_taps_and_traces(cnn_data, batchnorm):
    """Logits and loss within 1e-5; tap shapes and the activation sites
    and values equal; the report on a tuple batch (EF weight and
    activation traces, ranges, sizes) within 1e-4."""
    x, y = cnn_data[0][:16], cnn_data[1][:16]
    jp = jcnn.init_cnn(jax.random.key(0), num_classes=4, input_hw=8, filters=8,
                       batchnorm=batchnorm)
    tp = params_from_numpy(_np(jp), device="cpu")
    jl = jcnn.cnn_forward(jp, jnp.asarray(x))
    with torch.no_grad():
        tl = tcnn.cnn_forward(tp, torch.from_numpy(x))
        tloss = float(tcnn.cnn_loss(tp, _tt(x, y)))
        acts = tcnn.cnn_act_fn(tp, _tt(x, y))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tloss, float(jcnn.cnn_loss(jp, _jj(x, y))), rtol=1e-5)
    jshapes = jcnn.cnn_tap_shapes(jp, (x, y))
    tshapes = tcnn.cnn_tap_shapes(tp, (x, y))
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == \
        {k: s for k, (s, _) in tshapes.items()}
    jacts = jcnn.cnn_act_fn(jp, _jj(x, y))
    assert list(acts) == list(jacts) == list(jshapes)
    for k, a in jacts.items():
        # atol 1e-5 on O(1) activations: after three conv + batch-norm
        # layers fp32 sums in another order differ by up to ~2e-6
        np.testing.assert_allclose(acts[k].numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    jr = j_build(jcnn.cnn_loss, jcnn.cnn_tap_loss,
                 lambda b: jcnn.cnn_tap_shapes(jp, b), jcnn.cnn_act_fn, jp,
                 [_jj(x, y)], tolerance=None, max_batches=1)
    tr = t_build(tcnn.cnn_loss, tcnn.cnn_tap_loss,
                 lambda b: tcnn.cnn_tap_shapes(tp, b), tcnn.cnn_act_fn, tp,
                 [(x, y)], tolerance=None, max_batches=1, device="cpu")
    _reports_match(tr, jr)


def _reports_match(tr, jr):
    assert list(tr.weight_traces) == list(jr.weight_traces)
    assert tr.param_sizes == jr.param_sizes
    for k, v in jr.weight_traces.items():
        np.testing.assert_allclose(tr.weight_traces[k], v, rtol=1e-4, err_msg=k)
    for k, v in jr.weight_ranges.items():
        np.testing.assert_allclose(tr.weight_ranges[k], v, rtol=0, err_msg=k)
    assert sorted(tr.act_traces) == sorted(jr.act_traces) and jr.act_traces
    for k, v in jr.act_traces.items():
        np.testing.assert_allclose(tr.act_traces[k], v, rtol=1e-4, err_msg=k)
    for k, v in jr.act_ranges.items():
        np.testing.assert_allclose(tr.act_ranges[k], v, rtol=1e-5, err_msg=k)


def test_unet_forward_loss_taps_traces_and_miou():
    """The U-Net at its own widths on 16×16 segmentation images: logits
    and loss within 1e-5, tap shapes and sites equal, the report within
    1e-4, and ``unet_miou`` equal."""
    x, y = jsyn.segment_dataset(jsyn.SegmentConfig(input_hw=16), 6)
    jp = junet.init_unet(jax.random.key(0))
    tp = params_from_numpy(_np(jp), device="cpu")
    jl = junet.unet_forward(jp, jnp.asarray(x))
    with torch.no_grad():
        tl = tunet.unet_forward(tp, torch.from_numpy(x))
        tloss = float(tunet.unet_loss(tp, _tt(x, y)))
        acts = tunet.unet_act_fn(tp, _tt(x, y))
    assert tl.shape == (6, 16, 16, 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tloss, float(junet.unet_loss(jp, _jj(x, y))),
                               rtol=1e-5)
    jshapes = junet.unet_tap_shapes(jp, (x, y))
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == \
        {k: s for k, (s, _) in tunet.unet_tap_shapes(tp, (x, y)).items()}
    assert list(acts) == list(junet.unet_act_fn(jp, _jj(x, y))) == list(jshapes)
    assert tunet.unet_miou(tp, *_tt(x, y)) == junet.unet_miou(jp, *_jj(x, y))
    jr = j_build(junet.unet_loss, junet.unet_tap_loss,
                 lambda b: junet.unet_tap_shapes(jp, b), junet.unet_act_fn, jp,
                 [_jj(x, y)], tolerance=None, max_batches=1)
    tr = t_build(tunet.unet_loss, tunet.unet_tap_loss,
                 lambda b: tunet.unet_tap_shapes(tp, b), tunet.unet_act_fn, tp,
                 [(x, y)], tolerance=None, max_batches=1, device="cpu")
    _reports_match(tr, jr)


def test_upsample_is_the_references_nearest_resize():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(tunet._upsample(torch.from_numpy(x)).numpy(),
                                  np.asarray(junet._upsample(jnp.asarray(x))))


@pytest.fixture(scope="module")
def trained_cnn():
    """The reference's testbed CNN (tests/test_fit_metric.py's fixture:
    8×8 inputs, 4 classes, 8 filters, no batch-norm), trained by SGD in
    the reference; its params carried to the port."""
    dcfg = jsyn.ClassifyConfig(input_hw=8, num_classes=4, seed=1)
    xtr, ytr = jsyn.classify_dataset(dcfg, 2048)
    xte, yte = jsyn.classify_dataset(dcfg, 512, split_seed=7)
    params = jcnn.init_cnn(jax.random.key(0), num_classes=4, input_hw=8,
                           filters=8, batchnorm=False)
    lr = 3e-3

    @jax.jit
    def step(p, batch):
        loss, g = jax.value_and_grad(jcnn.cnn_loss)(p, batch)
        return jax.tree.map(lambda a, b: a - lr * b, p, g), loss

    for i, b in enumerate(jsyn.batched(xtr, ytr, 128, seed=0)):
        if i >= 400:
            break
        params, _ = step(params, _jj(*b))
    return params, (xtr, ytr), (xte, yte)


def test_fit_and_qat_loss_per_config_match_reference(trained_cnn):
    """The paper's protocol on the reference's trained CNN: one report
    each (256 samples), the same 16 random mixed-precision configs; per
    config FIT and the QAT loss (``QATContext``, the plain dynamic
    fake-quant STE) within 1e-4 relative, the two Spearmans of FIT
    against the loss change within 0.02; test accuracy equal.

    The QAT loss is held at 2e-4 relative, not 1e-4: with 3-bit conv2
    weights and 6-bit act2, conv3's outputs lie on a lattice where some
    act3 values tie exactly with a rounding boundary of act3's 8-bit
    grid, and fp32 sums in another order (PyTorch's convolution against
    XLA's) put 9 and 23 of its 16,384 values one grid step apart in two
    of the 16 configs: 8.5e-5 and 1.03e-4 of the loss."""
    jp, (xtr, ytr), (xte, yte) = trained_cnn
    tp = params_from_numpy(_np(jp), device="cpu")
    assert tcnn.cnn_accuracy(tp, *_tt(xte, yte)) == \
        jcnn.cnn_accuracy(jp, *_jj(xte, yte))
    x, y = xtr[:256], ytr[:256]
    jr = j_build(jcnn.cnn_loss, jcnn.cnn_tap_loss,
                 lambda b: jcnn.cnn_tap_shapes(jp, b), jcnn.cnn_act_fn, jp,
                 [_jj(x, y)], tolerance=None, max_batches=1)
    tr = t_build(tcnn.cnn_loss, tcnn.cnn_tap_loss,
                 lambda b: tcnn.cnn_tap_shapes(tp, b), tcnn.cnn_act_fn, tp,
                 [(x, y)], tolerance=None, max_batches=1, device="cpu")
    _reports_match(tr, jr)
    jconfigs = j_sample(jr, JPolicy(allowed_bits=(8, 6, 4, 3),
                                    pinned_substrings=()), n=16, seed=3)
    tconfigs = t_sample(SensitivityReport.from_json(jr.to_json()),
                        TPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=()),
                        n=16, seed=3)
    assert [(c.weight_bits, c.act_bits) for c in tconfigs] == \
        [(c.weight_bits, c.act_bits) for c in jconfigs]
    jbase = float(jcnn.cnn_loss(jp, _jj(x, y)))
    with torch.no_grad():
        tbase = float(tcnn.cnn_loss(tp, _tt(x, y)))
    np.testing.assert_allclose(tbase, jbase, rtol=1e-5)
    jf, jd, tf, td = [], [], [], []
    for jc, tc in zip(jconfigs, tconfigs):
        lw = {k: float(2 ** b - 1) for k, b in jc.weight_bits.items()}
        la = {k: float(2 ** b - 1) for k, b in jc.act_bits.items()}
        jq = float(jcnn.cnn_loss(jp, _jj(x, y), ctx=JQAT(lw, la)))
        with torch.no_grad():
            tq = float(tcnn.cnn_loss(tp, _tt(x, y), ctx=TQAT(lw, la)))
        np.testing.assert_allclose(tq, jq, rtol=2e-4)
        jf.append(jr.fit(jc))
        tf.append(tr.fit(bit_config_from_reference(tc)))
        np.testing.assert_allclose(tf[-1], jf[-1], rtol=1e-4)
        jd.append(jq - jbase)
        td.append(tq - tbase)
    rho_j, rho_t = j_spearman(jf, jd), t_spearman(tf, td)
    assert abs(rho_t - rho_j) <= 0.02, (rho_t, rho_j)
    print(f"Spearman(FIT, dloss) over 16 configs: port {rho_t:.4f}, "
          f"reference {rho_j:.4f}")


def test_quickstart_example_runs_on_the_cpu():
    """``examples/quickstart_torch.py --device cpu``: train, report, the
    greedy allocations and the Pareto front, in a process of its own."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(root / "examples" / "quickstart_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    acc = float(out.stdout.split("FP accuracy:")[1].split()[0])
    assert acc > 0.7, out.stdout
    for line in ("per-block EF traces", "per-site EF traces",
                 "budget 4 bits/param", "Pareto front"):
        assert line in out.stdout, out.stdout
