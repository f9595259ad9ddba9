"""Static verification for the quantized serving stack (port of
``repro.analysis``).

Three passes, one CLI (``python -m repro_torch.analysis``):

  * ``dispatch_check`` — run the kernel wrappers and the engine's
    admission and burst steps eagerly under a recording dispatch mode and
    verify the numerics and zero-sync invariants (RPR1xx);
  * ``bounds``         — symbolic worst-case interval analysis of the
    int8/qmm accumulators for every config x policy bit level (RPR2xx);
  * ``lint``           — repo-specific AST rules over ``src/repro_torch``
    (RPR0xx).

Findings carry stable rule codes; see ``findings.RULES`` and the README
"Static analysis" section. ``run_all`` is what the CLI and the tests
call. This module stays import-light: the passes load on use.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch._device import DeviceLike
from repro_torch.analysis.findings import RULES, Finding, Report  # noqa: F401


def run_all(dispatch: bool = True, bounds: bool = True, lint: bool = True,
            sharded: Optional[bool] = None,
            device: DeviceLike = None,
            stats: Optional[Dict[str, Dict]] = None) -> Report:
    """Run the selected passes and return the combined report. The
    dispatch pass runs its targets on ``device`` (default: the GPU;
    ``"cpu"`` for the plain versions); ``sharded=False`` leaves out the
    two-shard engine targets (the port is single-controller, so it runs
    by default on one device); ``stats`` receives each dispatch target's
    op count and, on the card, its synchronizing calls."""
    report = Report()
    if bounds:
        from repro_torch.analysis import bounds as _bounds
        report.extend(_bounds.run())
    if lint:
        from repro_torch.analysis import lint as _lint
        report.extend(_lint.run())
    if dispatch:
        from repro_torch.analysis import dispatch_check as _dispatch
        variants = tuple(v for v in _dispatch.ENGINE_VARIANTS
                         if sharded is not False
                         or v not in ("sharded", "moe-ep"))
        report.extend(_dispatch.run(device=device, variants=variants,
                                    stats=stats))
    return report
