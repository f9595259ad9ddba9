"""Repo-specific AST lint: the RPR0xx rules (port of
``repro.analysis.lint``), in their torch forms.

Rules the generic linters cannot know — they encode this package's
quantization and zero-sync contracts (pack units, exact cross-shard
sums, int-only kernel numerics, one host read a burst). Pure AST over
``src/repro_torch`` (plus one semantic table check, RPR005)::

    PYTHONPATH=src python -m repro_torch.analysis --lint

Suppress a rule at one site with ``# rpr-ok: CODE reason`` on the
flagged line or the line directly above. The reason is mandatory: the
marker is an audit record, not an off-switch.

Rule summary (rationales live in ``findings.RULES``):

  RPR001  literal quantize() call whose group_size splits a pack unit
  RPR002  psum / psum_scatter / all_reduce / all_gather_invariant call
          (``TPMesh.psum`` included) without an exactness marker
  RPR003  torch.float64 / torch.double / .double() / "float64"
  RPR004  float() or .item() on a non-constant value in kernel code
  RPR005  qtensor pack tables out of sync (PACKED_BITS vs _UNITS)
  RPR006  iteration over a set
  RPR007  bare assert for validation in kernel code
  RPR008  host sync (.cpu() / .item() / .tolist() / .numpy() /
          torch.cuda.synchronize / np.asarray) inside a serving hot-path
          function (engine_step / spec_step / burst / drain) under serve/
          or obs/
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding, suppressed_codes

# cross-shard sums: every call site must carry an audit marker saying WHY
# its operand is exact (int32, or zero-padded disjoint slots)
_COLLECTIVES = {"psum", "psum_scatter", "all_reduce", "all_gather_invariant"}

# directories (relative to the scan root) held to the kernel-grade rules
_KERNEL_DIRS = ("kernels",)

# RPR008: directories holding serving hot-path code, the function-name
# fragments that mark a decode hot path, and the methods that read a
# device value on the host (``torch.cuda.synchronize`` is matched by
# name; ``np.asarray`` of a device tensor copies it to the host)
_HOT_DIRS = ("serve", "obs")
_HOT_NAME_FRAGMENTS = ("engine_step", "spec_step", "burst", "drain")
_HOT_SYNC_METHODS = {"cpu", "item", "tolist", "numpy", "synchronize"}


def _is_float64_attr(node: ast.AST) -> bool:
    # torch.float64 / torch.double; host-side np.float64 is fine (numpy
    # arrays never reach a kernel)
    return (isinstance(node, ast.Attribute)
            and node.attr in ("float64", "double")
            and isinstance(node.value, ast.Name) and node.value.id == "torch")


def _int_literal(node: Optional[ast.AST]) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _call_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _pack_unit(bits: int) -> int:
    from repro_torch.qtensor import pack_unit
    return pack_unit(bits)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        parts = Path(rel).parts[:-1]
        self.in_kernel_dir = any(part in _KERNEL_DIRS for part in parts)
        self.in_hot_dir = any(part in _HOT_DIRS for part in parts)
        self._func_stack: List[str] = []

    def _add(self, code: str, severity: str, node: ast.AST, msg: str) -> None:
        lineno = getattr(node, "lineno", 1)
        if code in suppressed_codes(self.lines, lineno):
            return
        self.findings.append(Finding(code, severity, self.rel, msg,
                                     line=lineno, path=self.rel))

    # --- RPR008: hot-path host syncs --------------------------------------
    def _in_hot_function(self) -> bool:
        return self.in_hot_dir and any(
            frag in fn for fn in self._func_stack
            for frag in _HOT_NAME_FRAGMENTS)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_hot_sync(self, node: ast.Call, name: str) -> None:
        if not self._in_hot_function():
            return
        is_sync = isinstance(node.func, ast.Attribute) and \
            name in _HOT_SYNC_METHODS
        # np.asarray(<device tensor>) is an implicit blocking copy to the
        # host; only the np attribute form is flagged
        if name == "asarray" and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "np":
            is_sync = True
        if is_sync:
            self._add(
                "RPR008", "error", node,
                f"{name}() inside a serving hot-path function "
                f"({'.'.join(self._func_stack)}) — per-burst host syncs "
                "defeat the zero-sync decode contract; move the transfer "
                "to the audited fetch or mark the site with "
                "'# rpr-ok: RPR008 <why this sync is the burst's one read "
                "/ on the drain cadence>'")

    # --- RPR001 / RPR002 / RPR003 / RPR004 --------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        self._check_hot_sync(node, name)
        if name in _COLLECTIVES:
            self._add(
                "RPR002", "error", node,
                f"{name} without an exactness audit marker; add "
                "'# rpr-ok: RPR002 <why the operand is exact>' (int32, or "
                "zero-padded disjoint-slot fp32 per the row-parallel "
                "contract)")
        if name == "double" and isinstance(node.func, ast.Attribute) \
                and not node.args:
            self._add("RPR003", "error", node,
                      ".double() on a tensor — doubles are outside every "
                      "exactness contract here")
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Constant) and arg.value == "float64":
                self._add("RPR003", "error", arg,
                          "'float64' dtype string — doubles are outside "
                          "every exactness contract here")
        if self.in_kernel_dir and (
                (name == "float" and isinstance(node.func, ast.Name)
                 and node.args and not isinstance(node.args[0], ast.Constant))
                or (name == "item" and isinstance(node.func, ast.Attribute))):
            self._add("RPR004", "warning", node,
                      f"{name}() on a non-constant value in kernel code — "
                      "a host read of a device value; keep kernel values as "
                      "tensors or static python ints")
        if name in ("quantize", "qt_quantize"):
            self._check_quantize_literals(node)
        self.generic_visit(node)

    def _check_quantize_literals(self, node: ast.Call) -> None:
        bits = _int_literal(node.args[1]) if len(node.args) > 1 else None
        gs = _int_literal(node.args[2]) if len(node.args) > 2 else None
        for kw in node.keywords:
            if kw.arg == "bits":
                bits = _int_literal(kw.value)
            elif kw.arg == "group_size":
                gs = _int_literal(kw.value)
        if bits is None or gs is None:
            return
        unit = _pack_unit(bits)
        if gs % unit:
            self._add(
                "RPR001", "error", node,
                f"quantize(bits={bits}, group_size={gs}): group_size must "
                f"be a multiple of the {bits}-bit pack unit ({unit}) or the "
                "packed payload tiles split a byte/3-byte unit")

    # --- RPR003 (attribute form) ------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _is_float64_attr(node):
            self._add("RPR003", "error", node,
                      f"torch.{node.attr} in the package — doubles are "
                      "outside every exactness contract of the quantized "
                      "stack")
        self.generic_visit(node)

    # --- RPR006: set iteration --------------------------------------------
    def _check_iter(self, it: ast.AST, node: ast.AST) -> None:
        is_set = isinstance(it, (ast.Set, ast.SetComp)) or (
            isinstance(it, ast.Call) and _call_name(it.func) == "set")
        if is_set:
            self._add(
                "RPR006", "warning", node,
                "iterating a set — set order is hash-dependent; wrap it in "
                "sorted() so tree and shard orders are deterministic "
                "across processes")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter, node)
        self.generic_visit(node)

    def visit_comprehension_like(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter, node)
        self.generic_visit(node)

    visit_ListComp = visit_comprehension_like
    visit_DictComp = visit_comprehension_like
    visit_GeneratorExp = visit_comprehension_like

    # --- RPR007: bare assert in kernel code -------------------------------
    def visit_Assert(self, node: ast.Assert) -> None:
        if self.in_kernel_dir:
            self._add(
                "RPR007", "error", node,
                "bare assert for validation in kernel code — stripped "
                "under 'python -O'; raise ValueError with a diagnostic "
                "instead")
        self.generic_visit(node)


def lint_source(source: str, rel: str, path: str = "") -> List[Finding]:
    """Lint one file's source text (``rel`` is the repo-relative path)."""
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding("RPR003", "error", rel,
                        f"file does not parse: {e}", line=e.lineno, path=rel)]
    linter = _Linter(path or rel, rel, source)
    linter.visit(tree)
    return linter.findings


def _check_pack_tables(packed_bits=None, units=None) -> List[Finding]:
    """RPR005: the qtensor pack tables must agree with each other (the
    package's own tables unless both are given)."""
    from repro_torch import qtensor
    if units is None:
        units = getattr(qtensor.qtensor, "_UNITS", {})
    packed = set(qtensor.PACKED_BITS if packed_bits is None else packed_bits)
    out: List[Finding] = []
    if packed != set(units):
        out.append(Finding(
            "RPR005", "error", "repro_torch.qtensor",
            f"PACKED_BITS {sorted(packed)} and _UNITS keys "
            f"{sorted(units)} disagree — every packed width needs a "
            "(values, bytes) unit and vice versa"))
    for bits, (vals, nbytes) in sorted(units.items()):
        if vals <= 0 or nbytes <= 0 or (bits * vals) > (8 * nbytes):
            out.append(Finding(
                "RPR005", "error", "repro_torch.qtensor",
                f"_UNITS[{bits}] = ({vals}, {nbytes}) cannot hold {vals} "
                f"{bits}-bit values in {nbytes} bytes"))
    return out


def run(root: Optional[str] = None,
        paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint ``src/repro_torch`` (or explicit ``paths``) and the pack tables."""
    findings = list(_check_pack_tables())
    if paths:
        files = [Path(p) for p in paths]
        base = Path(root) if root else Path.cwd()
    else:
        base = Path(root) if root else Path(__file__).resolve().parents[2]
        files = sorted((base / "repro_torch").rglob("*.py"))
    for f in files:
        try:
            rel = str(f.relative_to(base))
        except ValueError:
            rel = str(f)
        findings.extend(lint_source(f.read_text(), rel, str(f)))
    return findings
