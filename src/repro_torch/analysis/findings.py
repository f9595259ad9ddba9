"""Finding records shared by the three analysis passes (port of
``repro.analysis.findings``).

Every pass (``dispatch_check``, ``bounds``, ``lint``) reports its results
as a list of :class:`Finding`. A finding carries a stable rule code
(``RPRxxx``), a severity, a location string (``path:line`` for lint, a
target name for dispatch and bounds findings), and a message.

Severity semantics:

* ``error``   — violates a bit-exactness or zero-sync invariant; the CLI
  exits non-zero.
* ``warning`` — numerically suspect but explicitly tolerated (documented
  contract, e.g. the fp32 group-fold exactness tier); reported, exit 0.
* ``info``    — environmental notes (e.g. a target skipped because its
  code path is not ported); reported, exit 0.

Inline suppression: a source line (or the line directly above it) may
carry ``# rpr-ok: CODE reason`` to waive one rule at that site. The
reason is mandatory — a bare marker does not suppress anything.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

SEVERITIES = ("error", "warning", "info")

# Stable rule registry: code -> one-line rationale (the reference's codes,
# stated for torch). Documented in the README.
RULES: dict[str, str] = {
    # --- lint (AST) ---
    "RPR001": "literal quantize() call with a rows/pack-unit or "
    "scale-group divisibility violation",
    "RPR002": "cross-shard sum (TPMesh.psum / all_reduce) without an "
    "exactness audit marker (int32 or zero-padded disjoint-slot fp32 "
    "required)",
    "RPR003": "torch.float64 / .double() / 'float64' in the package "
    "(doubles are never exact-contract dtypes here)",
    "RPR004": "float() or .item() on a tensor value inside kernel code "
    "(a host read of a device value)",
    "RPR005": "packed-width tables out of sync: qtensor pack-unit table "
    "does not cover every width in PACKED_BITS",
    "RPR006": "iteration over a set without sorted() (iteration-order "
    "hazard for flatten/unflatten and shard order)",
    "RPR007": "bare assert used for shape/numeric validation in kernel "
    "code (stripped under python -O; raise ValueError instead)",
    "RPR008": "host sync (.cpu() / .item() / .tolist() / .numpy() / "
    "torch.cuda.synchronize / np.asarray) inside a serving hot-path "
    "function — defeats the zero-sync decode contract; only the audited "
    "fetches may transfer",
    # --- dispatch (eager aten ops under a TorchDispatchMode) ---
    "RPR100": "analysis environment note: target skipped or failed",
    "RPR101": "float64 tensor in a dispatched computation",
    "RPR102": "lossy dtype conversion on an accumulation path "
    "(int32 -> fp16/bf16 before the scale fold)",
    "RPR103": "device-to-host synchronization or host upload in the "
    "decode hot path",
    "RPR104": "cross-shard sum whose operand is not exactness-safe "
    "(not an integer dtype)",
    # --- bounds ---
    "RPR201": "int32 accumulator can overflow: group dot worst case "
    ">= 2^31 for an emittable BitConfig",
    "RPR202": "int32 accumulator can overflow: full-K int8 matmul worst "
    "case >= 2^31",
    "RPR203": "fp32 group fold leaves the exact-integer range "
    "(worst-case |group dot| > 2^24); scale fold may round",
}

_SUPPRESS_RE = re.compile(r"#\s*rpr-ok:\s*(RPR\d{3})\s+(\S.*)")


@dataclass
class Finding:
    code: str
    severity: str
    where: str
    message: str
    line: int | None = None
    path: str | None = None

    def __post_init__(self) -> None:
        if self.code not in RULES:
            raise ValueError(f"unknown rule code {self.code!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        loc = self.where
        if self.path is not None and self.line is not None:
            loc = f"{self.path}:{self.line}"
        return f"{self.severity.upper():7s} {self.code} {loc}: {self.message}"

    def render_github(self) -> str:
        """GitHub Actions workflow-command annotation."""
        level = {"error": "error", "warning": "warning", "info": "notice"}[self.severity]
        parts = []
        if self.path is not None:
            parts.append(f"file={self.path}")
            if self.line is not None:
                parts.append(f"line={self.line}")
        header = f"::{level} " + ",".join(parts) if parts else f"::{level}"
        msg = f"{self.code}: {self.message}".replace("%", "%25").replace("\n", "%0A")
        return f"{header}::{msg}"


@dataclass
class Report:
    """Accumulated findings from one or more passes."""

    findings: list[Finding] = field(default_factory=list)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: list[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def exit_code(self) -> int:
        return 1 if self.errors else 0


def suppressed_codes(source_lines: list[str], lineno: int) -> set[str]:
    """Rule codes waived at 1-based ``lineno`` via ``# rpr-ok: CODE reason``.

    The marker may sit on the flagged line itself or on the line directly
    above it. A marker without a reason is ignored.
    """
    codes: set[str] = set()
    for idx in (lineno - 1, lineno - 2):
        if 0 <= idx < len(source_lines):
            m = _SUPPRESS_RE.search(source_lines[idx])
            if m:
                codes.add(m.group(1))
    return codes
