"""The paper's experiments on the port, in the reference harness's order
(twin of the reference's ``benchmarks/run.py``, its paper modules only).

    PYTHONPATH=src python -m repro_torch.paper.run [--device cpu] [--out PATH]

Prints ``name,us_per_call,derived`` CSV rows. The reference's environment
variables select and size the protocol: ``REPRO_BENCH=table1,fig1``
picks modules; ``REPRO_T2_CONFIGS``, ``REPRO_T2_QAT_STEPS``,
``REPRO_F4_CONFIGS``, ``REPRO_F4_QAT_STEPS`` and ``REPRO_F5_CONFIGS``
size Tables 2 and Figs. 4–5. ``--out`` writes every module's numbers as
one JSON file. A failing module makes the process exit 1. The modules
run with cuDNN's deterministic convolution algorithms and without TF32
(``common.reproducible``), so one seed gives one fp32 result on the
card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch._device import resolve_device
from repro_torch.paper.common import reproducible

MODULES = [
    ("table1", "repro_torch.paper.table1_estimator"),
    ("fig1", "repro_torch.paper.fig1_trace_similarity"),
    ("fig2", "repro_torch.paper.fig2_convergence"),
    ("table2", "repro_torch.paper.table2_rankcorr"),
    ("fig4", "repro_torch.paper.fig4_segmentation"),
    ("fig5", "repro_torch.paper.fig5_assumptions"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--out", default=None, help="write the numbers here (JSON)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sel = os.environ.get("REPRO_BENCH")
    chosen = sel.split(",") if sel else [n for n, _ in MODULES]
    print("name,us_per_call,derived")
    results, failures, seconds = {}, [], {}
    for name, mod in MODULES:
        if name not in chosen:
            continue
        t0 = time.time()
        try:
            with reproducible():
                results[name] = importlib.import_module(mod).run(device=dev)
            seconds[name] = time.time() - t0
            print(f"{name}.elapsed_s,{seconds[name] * 1e6:.0f},ok", flush=True)
        except Exception as e:  # noqa: BLE001 — harness boundary
            failures.append((name, repr(e)))
            traceback.print_exc()
            print(f"{name}.elapsed_s,{(time.time() - t0) * 1e6:.0f},FAILED:{e!r}",
                  flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "protocol": {k: os.environ[k] for k in (
                "REPRO_BENCH", "REPRO_T2_CONFIGS", "REPRO_T2_QAT_STEPS",
                "REPRO_F4_CONFIGS", "REPRO_F4_QAT_STEPS", "REPRO_F5_CONFIGS")
                if k in os.environ},
            "seconds": seconds, "results": results,
            "failures": failures}, indent=1, default=str))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
