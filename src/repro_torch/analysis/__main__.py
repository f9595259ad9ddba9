"""CLI for the static verification passes.

    PYTHONPATH=src python -m repro_torch.analysis --all [--device cpu]

The dispatch pass runs its targets on the GPU (``_device.resolve_device``
raises without one) unless ``--device cpu`` is given; on the card it also
counts every synchronizing CUDA call of the hot targets. Exit code 1 iff
any error-severity finding; warnings and info notes print but do not
gate.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static numerics/zero-sync verification (RPR rules)")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when none selected)")
    ap.add_argument("--dispatch", action="store_true",
                    help="dispatch-level numerics and sync checker (RPR1xx)")
    ap.add_argument("--bounds", action="store_true",
                    help="accumulator bound analyzer (RPR2xx)")
    ap.add_argument("--lint", action="store_true",
                    help="package AST lint (RPR0xx)")
    ap.add_argument("--device", default=None,
                    help="device of the dispatch targets (default: the GPU)")
    ap.add_argument("--github", action="store_true",
                    help="emit GitHub Actions annotations")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress warning/info findings")
    args = ap.parse_args(argv)

    selected = args.dispatch or args.bounds or args.lint
    want = (lambda x: x) if selected and not args.all else (lambda x: True)

    from repro_torch.analysis import run_all
    t0 = time.perf_counter()
    report = run_all(dispatch=want(args.dispatch), bounds=want(args.bounds),
                     lint=want(args.lint), device=args.device)
    dt = time.perf_counter() - t0

    shown = report.findings if not args.quiet else report.errors
    for f in sorted(shown, key=lambda f: (f.severity != "error", f.code,
                                          f.where, f.line or 0)):
        print(f.render())
        if args.github:
            print(f.render_github())
    n_err, n_warn = len(report.errors), len(report.warnings)
    n_info = len(report.findings) - n_err - n_warn
    print(f"repro_torch.analysis: {n_err} error(s), {n_warn} warning(s), "
          f"{n_info} note(s) in {dt:.1f}s")
    return report.exit_code()


if __name__ == "__main__":
    sys.exit(main())
