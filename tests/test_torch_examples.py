"""The port's example scripts and the paper harness, each in a process of
its own on the CPU (``--device cpu``) at its smallest flags: each exits 0
and prints its key lines."""
import json
import os
import pathlib
import re
import subprocess
import sys

from _torch_threads import _one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args, timeout=300, **env):
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1", **env))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_serve_quantized_example():
    """Report, W4/W8 allocation, packed storage (payload == FIT-predicted
    bytes at W8/W4), per-request agreement, seeded sampling twice
    identical, FIT KV widths and the paged prefix-shared engine."""
    out = _run(["examples/serve_quantized_torch.py", "--device", "cpu",
                "--requests", "2"])
    assert re.search(r"allocation \(mixed\): \{4: \d+, 8: \d+\}", out), out
    assert re.search(r"packed payload (\d+) B == FIT-predicted \1 B: True", out), out
    assert len(re.findall(r"  req \d+: prompt=.* agree=", out)) == 2, out
    assert "identical samples: True" in out
    assert re.search(r"KV bits per layer @ \d+B budget", out), out
    assert "paged QTensor-page engine: 2 finished" in out, out
    assert "kernel launches on cpu: ef_sqnorm 0, qmm 0, paged_attention 0" in out


def test_mpq_search_example():
    """Pretraining, the report, greedy against uniform-4, 4,096 configs
    scored at once, packed storage and QAT of both configs."""
    out = _run(["examples/mpq_search_torch.py", "--device", "cpu"])
    for line in ("step 100 loss", "FIT(greedy@4.5b) =", "scored 4096 configs",
                 "most sensitive blocks:", "greedy@4.5b materialized:",
                 "final QAT loss  fp="):
        assert line in out, (line, out)
    losses = [float(v) for v in re.findall(r"step \d+ loss ([\d.]+)", out)]
    assert len(losses) == 3 and losses[-1] < losses[0], out


def test_train_e2e_example_trains_and_resumes(tmp_path):
    """4 QAT steps with a checkpoint, then the same command at 6 steps
    resumes from step 4."""
    args = ["examples/train_e2e_torch.py", "--steps", "4", "--dim", "64",
            "--layers", "2", "--qat", "4", "--device", "cpu",
            "--ckpt", str(tmp_path / "ck")]
    out = _run(args)
    assert re.search(r"final loss: [\d.]+ \(from [\d.]+\)", out), out
    assert (tmp_path / "ck" / "step_00000004").exists()
    args[args.index("4")] = "6"
    out = _run(args)
    assert "final loss:" in out and (tmp_path / "ck" / "step_00000006").exists()


def test_paper_harness_runs_fig5(tmp_path):
    """``python -m repro_torch.paper.run`` honours ``REPRO_BENCH`` and
    ``REPRO_F5_CONFIGS`` and writes its numbers where ``--out`` points."""
    js = tmp_path / "paper.json"
    out = _run(["-m", "repro_torch.paper.run", "--device", "cpu", "--out", str(js)],
               REPRO_BENCH="fig5", REPRO_F5_CONFIGS="3")
    assert out.splitlines()[0] == "name,us_per_call,derived"
    for name in ("fig5.frac_noise_below_param_3bit", "fig5.fit_train_acc_spearman",
                 "fig5.fit_test_acc_spearman"):
        assert re.search(rf"^{name},0\.00,-?[\d.]+$", out, re.M), (name, out)
    assert re.search(r"^fig5\.elapsed_s,\d+,ok$", out, re.M), out
    assert "table1." not in out
    got = json.loads(js.read_text())
    assert got["device"] == "cpu" and not got["failures"]
    assert got["protocol"] == {"REPRO_BENCH": "fig5", "REPRO_F5_CONFIGS": "3"}
    assert got["results"]["fig5"]["configs"] == 3
