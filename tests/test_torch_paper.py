"""The paper's experiments on the port (``repro_torch.paper``) against the
reference's scripts (``benchmarks/``) at a small protocol on the CPU.

Both sides get the same numpy data and batches; the port starts from the
reference's init (or its trained parameters), converted. The reference
side calls ``repro.*`` and the scripts' pure helpers
(``benchmarks.common.train_cnn_testbed``, ``table2_rankcorr._study`` and
``_qat_accuracy``, ``fig2_convergence._iters_to_tolerance``) and never a
``run()`` that writes files. Hutchinson's probes come from another
random-number generator in each package: the Hessian-vector products are
held on the same numpy probes, and each package's Hutchinson means
within a band of standard errors of the other's (or of the exact
traces)."""
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's benchmarks/ scripts
    sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import fig2_convergence as jf2, table2_rankcorr as jt2  # noqa: E402
from repro.core import (build_report as j_build, ef_trace_weights as j_ef,  # noqa: E402
                        exact_block_traces as j_exact,
                        hutchinson_block_traces as j_hutch,
                        metric_accuracy_correlation as j_mac,
                        sample_configs as j_sample)
from repro.core.hessian import hvp as j_hvp  # noqa: E402
from repro.core.rankcorr import spearman as j_spearman  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import cnn as jcnn, unet as junet  # noqa: E402
from repro.models.context import QATContext as JQAT  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.quant.quantizer import QuantSpec as JSpec, fake_quant_ref as j_fq  # noqa: E402
from repro.utils.pytree import named_leaves as j_named  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (build_report as tbuild, exact_block_traces,  # noqa: E402
                              hutchinson_block_traces, hvp)
from repro_torch.models import cnn as tcnn, unet as tunet  # noqa: E402
from repro_torch.paper import (common, fig1_trace_similarity as fig1,  # noqa: E402
                               fig2_convergence as fig2, fig4_segmentation as fig4,
                               fig5_assumptions as fig5, table1_estimator as table1,
                               table2_rankcorr as table2)
from repro_torch.utils.pytree import named_leaves  # noqa: E402
from _torch_threads import _one_thread  # noqa: F401,E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _reference_oracles():
    """The reference side runs its jnp oracles (``REPRO_KERNELS=ref``), not
    its Pallas kernels in interpret mode: the port's plain versions are
    held against those oracles elsewhere, and interpret mode costs
    seconds a call here."""
    old = os.environ.get("REPRO_KERNELS")
    os.environ["REPRO_KERNELS"] = "ref"
    yield
    if old is None:
        del os.environ["REPRO_KERNELS"]
    else:
        os.environ["REPRO_KERNELS"] = old


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return params_from_numpy(_np(tree), device="cpu")


def _jj(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _tt(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _params_close(got, want, tol):
    """Every block within ``tol`` times the block's largest magnitude."""
    tl, jl = named_leaves(got), j_named(want)
    assert [n for n, _ in tl] == [n for n, _ in jl]
    for (name, t), (_, j) in zip(tl, jl):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=tol * np.abs(j).max(), err_msg=name)


def _traces_close(got, want, rtol=1e-4):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def testbed():
    """The reference's testbed CNN (seed 0, no batch-norm, 300 SGD steps)
    and its data; the port's copy of its trained parameters."""
    jp, train, test, acc = jcommon.train_cnn_testbed(seed=0, batchnorm=False)
    return jp, _port(jp), train, test, acc


@pytest.mark.parametrize("batchnorm", [False, True])
def test_train_cnn_testbed_matches_reference(batchnorm):
    """``common.train_cnn_testbed`` from the reference's init: the same
    data; after 100 SGD steps every block within ``tol`` times its
    largest magnitude (fp32 sums in another order drift a few ulps a
    step: 2.5e-7 of a block without batch-norm, 2.4e-4 of a beta with it,
    where the batch statistics amplify the drift), the test accuracy
    within one test sample of 512."""
    seed, steps = 3, 100
    jp0 = jcnn.init_cnn(jax.random.key(seed), num_classes=4, input_hw=8,
                        filters=8, batchnorm=batchnorm)
    jp, (jx, jy), (jxe, jye), jacc = jcommon.train_cnn_testbed(
        seed=seed, batchnorm=batchnorm, steps=steps)
    tp, (tx, ty), (txe, tye), tacc = common.train_cnn_testbed(
        seed=seed, batchnorm=batchnorm, steps=steps, device="cpu",
        params=_port(jp0))
    for g, w in ((tx, jx), (ty, jy), (txe, jxe), (tye, jye)):
        assert np.array_equal(g, w)
    _params_close(tp, jp, tol=5e-4 if batchnorm else 1e-6)
    assert abs(tacc - jacc) <= 1 / 512 + 1e-9, (tacc, jacc)


def test_hvp_per_probe_matches_reference(testbed):
    """Hessian-vector products on the trained CNN, on the same numpy
    Rademacher probes in both packages, probe by probe, within 1e-4; so
    are the per-block restrictions rᵀ(Hr) Hutchinson averages."""
    jp, tp, (xtr, ytr), _, _ = testbed
    x, y = xtr[:64], ytr[:64]
    rng = np.random.default_rng(5)
    for _ in range(3):
        vec = jax.tree.map(lambda a: rng.choice(np.array([-1.0, 1.0], np.float32),
                                                a.shape), _np(jp))
        want = j_hvp(jcnn.cnn_loss, jp, _jj(x, y), jax.tree.map(jnp.asarray, vec))
        got = hvp(tcnn.cnn_loss, tp, _tt(x, y), params_from_numpy(vec, device="cpu"))
        for (name, g), (_, w), (_, r) in zip(named_leaves(got), j_named(want),
                                             j_named(vec)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)
            np.testing.assert_allclose(float(np.sum(r * g.numpy())),
                                       float(np.sum(r * w)), rtol=1e-4, err_msg=name)


def test_exact_block_traces_match_reference_at_a_tiny_width():
    """Exact per-block Hessian traces (one Hessian row a parameter) of a
    CNN 2 filters wide on 4×4 inputs: within 1e-4 of the reference's; the
    port's Hutchinson means (256 probes) within 5 standard errors of
    them."""
    dcfg = jsyn.ClassifyConfig(input_hw=4, num_classes=2, seed=2)
    x, y = jsyn.classify_dataset(dcfg, 16)
    jp = jcnn.init_cnn(jax.random.key(1), num_classes=2, input_hw=4, filters=2,
                       batchnorm=False)
    tp = _port(jp)
    want = j_exact(jcnn.cnn_loss, jp, _jj(x, y))
    got = exact_block_traces(tcnn.cnn_loss, tp, _tt(x, y))
    assert sum(int(np.prod(a.shape)) for _, a in j_named(jp)) == 280
    _traces_close(got, want)
    gen = torch.Generator().manual_seed(0)
    means, samples = hutchinson_block_traces(tcnn.cnn_loss, tp, _tt(x, y), gen,
                                             iters=256)
    for k, v in want.items():
        se = samples[k].std() / np.sqrt(len(samples[k]))
        assert abs(means[k] - v) <= 5 * se + 1e-6, (k, means[k], v, se)


def test_fig1_traces_and_correlations(testbed):
    """Fig. 1 on the reference's trained CNN, 128 samples: EF traces within
    1e-4; each package's Hutchinson means (32 probes, its own generator)
    within 5 combined standard errors of the other's; the Spearman of EF
    against them within 0.2 of the reference's (one swap of two adjacent
    blocks of five moves it by 0.1), Pearson within 0.05."""
    jp, tp, (xtr, ytr), _, _ = testbed
    x, y = xtr[:128], ytr[:128]
    probes = 32
    got = fig1.measure(tp, _tt(x, y), CPU, probes=probes)
    jef = j_ef(jcnn.cnn_loss, jp, _jj(x, y))
    jhu, jsamples = j_hutch(jcnn.cnn_loss, jp, _jj(x, y), jax.random.key(0),
                            iters=probes)
    _traces_close(got["ef"], jef)
    for k in jhu:
        ts = np.asarray(got["hessian_samples"][k])
        assert len(ts) == probes and ts.mean() == pytest.approx(got["hessian"][k])
        se = np.sqrt(np.var(ts) / probes + np.var(jsamples[k]) / probes)
        assert abs(got["hessian"][k] - jhu[k]) <= 5 * se, (k, got["hessian"][k], jhu[k])
    blocks = sorted(jef)
    rho = j_spearman([jef[b] for b in blocks], [jhu[b] for b in blocks])
    assert got["blocks"] == len(blocks) == 5
    assert abs(got["ef_hessian_spearman"] - rho) <= 0.2, (got, rho)
    r = float(np.corrcoef([jef[b] for b in blocks], [jhu[b] for b in blocks])[0, 1])
    assert abs(got["ef_hessian_pearson"] - r) <= 0.05


def _reference_ef_series(jp, xtr, ytr, iters):
    """The EF estimates of the reference's Table-1 / Fig.-2 loops: batches
    of 32 drawn by one numpy generator of seed 0."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(iters):
        sel = rng.permutation(len(xtr))[:32]
        out.append(sum(j_ef(jcnn.cnn_loss, jp, _jj(xtr[sel], ytr[sel])).values()))
    return out


def test_table1_ef_series_and_variance(testbed):
    """Table 1's EF estimates on the same batches within 1e-4 each, its
    relative variance within 1e-2 relative (a variance of numbers that
    agree to ~1e-6); Hutchinson's estimates finite; the derived claims
    follow from the series and times."""
    jp, tp, (xtr, ytr), _, _ = testbed
    got = table1.measure(tp, xtr, ytr, CPU, iters=4)
    want = _reference_ef_series(jp, xtr, ytr, 4)
    np.testing.assert_allclose(got["ef_series"], want, rtol=1e-4)
    ref_var = np.var(want) / (np.mean(want) ** 2 + 1e-12)
    np.testing.assert_allclose(got["ef_variance_rel"], ref_var, rtol=1e-2)
    assert len(got["hessian_series"]) == 4
    assert np.all(np.isfinite(got["hessian_series"]))
    hu_v = np.var(got["hessian_series"]) / (np.mean(got["hessian_series"]) ** 2 + 1e-12)
    assert got["hessian_variance_rel"] == pytest.approx(hu_v)
    assert got["fixed_tolerance_speedup"] == pytest.approx(
        hu_v * got["hessian_s"] / (got["ef_variance_rel"] * got["ef_s"]))
    assert got["ef_s"] == float(np.median(got["ef_times"][table1.SKIP:]))


@pytest.mark.parametrize("case", range(6))
def test_fig2_iters_to_tolerance_numpy_equal(case):
    """``_iters_to_tolerance`` is the reference's: equal on noisy series
    that converge, never converge, start converged, or are all zero."""
    rng = np.random.default_rng(case)
    n = 60
    series = [1.0 + rng.normal(0, 0.3, n) / np.sqrt(np.arange(1, n + 1)),
              rng.normal(0, 1, n),
              np.full(n, 2.5),
              np.zeros(n),
              np.abs(rng.standard_cauchy(n)),
              np.linspace(1, 2, 12)][case]
    for tol, window in ((0.05, 5), (0.2, 3)):
        assert fig2._iters_to_tolerance(series, tol, window) == \
            jf2._iters_to_tolerance(series, tol, window)


def test_fig2_ef_series(testbed):
    """Fig. 2's EF series on the same batches within 1e-4 each; its
    iterations-to-5% equal the reference helper's on the port's series."""
    jp, tp, (xtr, ytr), _, _ = testbed
    got = fig2.measure(tp, xtr, ytr, CPU, iters=4)
    np.testing.assert_allclose(got["ef_series"],
                               _reference_ef_series(jp, xtr, ytr, 4), rtol=1e-4)
    assert got["ef_iters_to_5pct"] == jf2._iters_to_tolerance(np.array(got["ef_series"]))
    assert got["hessian_iters_to_5pct"] == \
        jf2._iters_to_tolerance(np.array(got["hessian_series"]))


def test_fig5_noise_fraction_and_per_config(testbed, monkeypatch):
    """Fig. 5 (a) on the trained CNN equal to the reference's; (b) over 6
    configs: FIT within 1e-4 each, train and test accuracies of the
    quantized model within two samples (of 512) each (fp32 convolution
    sums in another order put some activations on the other side of a
    rounding tie of their grid; ROADMAP § C), and the Spearmans
    within 0.15 (six configs: one transposition of adjacent ranks moves
    it by 0.03–0.06)."""
    jp, tp, (xtr, ytr), (xte, yte), _ = testbed
    frac = []
    for _, leaf in j_named(jp):
        if leaf.ndim >= 2:
            fq = j_fq(leaf, JSpec(bits=3))
            frac.append(np.mean(np.abs(np.asarray(fq - leaf)).ravel()
                                < np.abs(np.asarray(leaf)).ravel() + 1e-12))
    assert fig5.noise_below_magnitude(tp) == float(np.mean(frac))

    monkeypatch.setattr(fig5, "N_CONFIGS", 6)
    got = fig5.measure(tp, (xtr, ytr), (xte, yte), CPU)
    jr = j_build(jcnn.cnn_loss, jcnn.cnn_tap_loss,
                 lambda b: jcnn.cnn_tap_shapes(jp, b), jcnn.cnn_act_fn, jp,
                 [_jj(xtr[:256], ytr[:256])], tolerance=None, max_batches=1)
    configs = j_sample(jr, JPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=()),
                       6, seed=21)
    tr, te, fits = [], [], []
    for c in configs:
        lw = {k: float(2 ** b - 1) for k, b in c.weight_bits.items()}
        la = {k: float(2 ** b - 1) for k, b in c.act_bits.items()}
        for x, y, acc in ((xtr[:512], ytr[:512], tr), (xte, yte, te)):
            lg = jcnn.cnn_forward(jp, jnp.asarray(x), ctx=JQAT(lw, la))
            acc.append(float(jnp.mean(jnp.argmax(lg, -1) == jnp.asarray(y))))
        fits.append(jr.fit(c))
    np.testing.assert_allclose(got["fits"], fits, rtol=1e-4)
    np.testing.assert_allclose(got["train_accs"], tr, rtol=0, atol=2 / 512 + 1e-9)
    np.testing.assert_allclose(got["test_accs"], te, rtol=0, atol=2 / 512 + 1e-9)
    assert abs(got["fit_train_acc_spearman"] - j_mac(fits, tr)["spearman"]) <= 0.15
    assert abs(got["fit_test_acc_spearman"] - j_mac(fits, te)["spearman"]) <= 0.15


def test_table2_study_matches_reference(monkeypatch):
    """Study C (batch-norm, 8 filters) at 3 configs × 6 QAT steps, both
    packages from the reference's init: the same configs; every metric's
    value within 1e-4 per config (FIT included); the QAT accuracies within
    two test samples (of 512) each; every metric's Spearman within 0.15 of
    the reference ``_study``'s (over three configs a transposition moves
    it by 0.5, so the ranks agree); the headline summary its formula."""
    name, seed, bn, filters = table2.STUDIES[2]
    for mod in (jt2, table2):
        monkeypatch.setattr(mod, "N_CONFIGS", 3)
        monkeypatch.setattr(mod, "QAT_STEPS", 6)
    ref_accs, ref_vals = [], {}
    qat, mvb = jt2._qat_accuracy, jt2.metric_values_batch

    def spy_qat(*a):
        ref_accs.append(qat(*a))
        return ref_accs[-1]

    def spy_values(report, mname, *a, **kw):
        ref_vals[mname] = np.asarray(mvb(report, mname, *a, **kw))
        return ref_vals[mname]

    monkeypatch.setattr(jt2, "_qat_accuracy", spy_qat)
    monkeypatch.setattr(jt2, "metric_values_batch", spy_values)
    want = jt2._study(name, seed, bn, filters)
    jp0 = jcnn.init_cnn(jax.random.key(seed), num_classes=4, input_hw=8,
                        filters=filters, batchnorm=bn)
    got, detail = table2._study_detail(name, seed, bn, filters, device="cpu",
                                       params=_port(jp0))
    assert sorted(got) == sorted(want) and "BN" in got
    assert len(detail["accs"]) == len(ref_accs) == 3
    np.testing.assert_allclose(detail["accs"], ref_accs, rtol=0,
                               atol=2 / 512 + 1e-9)
    for mname, vals in ref_vals.items():
        np.testing.assert_allclose(detail[mname], vals, rtol=1e-4, err_msg=mname)
    assert abs(got["fp_acc"] - want["fp_acc"]) <= 1 / 512 + 1e-9
    for k, v in want.items():
        if k not in ("fp_acc", "acc_spread"):
            assert abs(got[k] - v) <= 0.15, (k, got[k], v)
    head = table2.summarize({name: got, "other": want})
    assert head["FIT_mean"] == pytest.approx((got["FIT"] + want["FIT"]) / 2)
    assert head["FIT_vs_FITW_gain"] == pytest.approx(
        head["FIT_mean"] - (got["FIT_W"] + want["FIT_W"]) / 2)


def test_fig4_small_matches_reference(monkeypatch):
    """Fig. 4 at a small protocol, both packages from the reference's
    U-Net init: after 12 SGD steps the parameters within 1e-5 of each
    block's largest magnitude and the fp mIoU within 1e-3; then, from the
    reference's trained parameters, 4 configs × 4 QAT steps: per config
    FIT within 1e-4 and the mIoU (computed inline, a class absent from
    prediction and labels counting 1) within 2e-3; the Spearman within
    0.2 (four configs: one transposition of adjacent ranks moves it by
    0.2). The configs are the reference's: the report lists its
    activation sites in the reference's (sorted) order."""
    steps, n_cfg, qat_steps = 12, 4, 4
    monkeypatch.setattr(fig4, "N_CONFIGS", n_cfg)
    monkeypatch.setattr(fig4, "QAT_STEPS", qat_steps)
    dcfg = jsyn.SegmentConfig(input_hw=16, seed=0)
    xtr, ytr = jsyn.segment_dataset(dcfg, 512)
    xte, yte = jsyn.segment_dataset(dcfg, 128, split_seed=3)
    jp0 = junet.init_unet(jax.random.key(0), base=8)

    def sgd(step, p, batches, n, *levels):
        for i, b in enumerate(batches):
            if i >= n:
                break
            p = step(p, _jj(*b), *levels)
        return p

    fp_step = jax.jit(lambda p, b: jax.tree.map(
        lambda a, g: a - 5e-3 * g, p, jax.grad(junet.unet_loss)(p, b)))
    # the levels tables are arguments: one compile serves every config
    qat_step = jax.jit(lambda p, b, lw, la: jax.tree.map(
        lambda a, g: a - 2e-3 * g, p,
        jax.grad(lambda pp: junet.unet_loss(pp, b, ctx=JQAT(lw, la)))(p)))
    predict = jax.jit(lambda p, x, lw, la: jnp.argmax(
        junet.unet_forward(p, x, ctx=JQAT(lw, la)), -1))
    jp = sgd(fp_step, jp0, jsyn.batched(xtr, ytr, 64, seed=0), steps)
    tp, train, test, t_miou = fig4.train_unet(CPU, params=_port(jp0), steps=steps)
    _params_close(tp, jp, tol=1e-5)
    assert abs(t_miou - junet.unet_miou(jp, *_jj(xte, yte))) <= 1e-3
    for g, w in zip(train + test, (xtr, ytr, xte, yte)):
        assert np.array_equal(g, w)

    jr = j_build(junet.unet_loss, junet.unet_tap_loss,
                 lambda b: junet.unet_tap_shapes(jp, b), junet.unet_act_fn, jp,
                 [_jj(xtr[:128], ytr[:128])], tolerance=None, max_batches=1)
    jfits, jmious = [], []
    for c in j_sample(jr, JPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=()),
                      n_cfg, seed=7):
        lw = {k: float(2 ** b - 1) for k, b in c.weight_bits.items()}
        la = {k: float(2 ** b - 1) for k, b in c.act_bits.items()}
        qp = sgd(qat_step, jp, jsyn.batched(xtr, ytr, 64, seed=5), qat_steps, lw, la)
        pred = predict(qp, jnp.asarray(xte), lw, la)
        ious = []
        for cc in range(4):
            inter = jnp.sum((pred == cc) & (jnp.asarray(yte) == cc))
            union = jnp.sum((pred == cc) | (jnp.asarray(yte) == cc))
            ious.append(float(jnp.where(union > 0, inter / union, 1.0)))
        jmious.append(float(np.mean(ious)))
        jfits.append(jr.fit(c))

    got = fig4.measure(_port(jp), train, test, CPU)
    assert got["configs"] == n_cfg
    np.testing.assert_allclose(got["fits"], jfits, rtol=1e-4)
    np.testing.assert_allclose(got["mious"], jmious, rtol=0, atol=2e-3)
    rho = j_mac(jfits, jmious)["spearman"]
    assert abs(got["fit_miou_spearman"] - rho) <= 0.2, (got["fit_miou_spearman"], rho)


def test_unet_report_lists_sites_in_the_references_order():
    """The U-Net's seven activation sites, tapped encoder to decoder, come
    out of the report sorted, as the reference's pytree of tap gradients
    gives them (tap order put ``up2_act`` before ``dec2_act``, so a
    sampled config quantized other sites than the reference's)."""
    x, y = jsyn.segment_dataset(jsyn.SegmentConfig(input_hw=16), 4)
    jp = junet.init_unet(jax.random.key(0))
    tp = _port(jp)
    jr = j_build(junet.unet_loss, junet.unet_tap_loss,
                 lambda b: junet.unet_tap_shapes(jp, b), junet.unet_act_fn, jp,
                 [_jj(x, y)], tolerance=None, max_batches=1)
    tr = tbuild(tunet.unet_loss, tunet.unet_tap_loss,
                lambda b: tunet.unet_tap_shapes(tp, b), tunet.unet_act_fn, tp,
                [(x, y)], tolerance=None, max_batches=1, device="cpu")
    assert list(tr.act_traces) == list(jr.act_traces) == sorted(jr.act_traces)
    assert list(tunet.unet_tap_shapes(tp, (x, y))) != sorted(jr.act_traces)


def test_paper_records_and_timing():
    """``emit`` records and prints the reference's CSV shape; the timers
    report a median over synchronized samples."""
    n = len(common.records())
    line = common.emit("paper.test_line", 1.5, "x")
    assert line == "paper.test_line,1.50,x"
    assert common.records("paper.test_line")[-1] == ("paper.test_line", 1.5, "x")
    assert len(common.records()) == n + 1
    stats = common.timeit_stats(lambda: torch.ones(4).sum(), iters=5, warmup=1,
                                discard=1)
    assert stats["n"] == 4 and stats["min_us"] <= stats["median_us"]
    assert common.steady_median([9.0, 1.0, 2.0, 3.0]) == 2.0
