"""Symbolic worst-case interval analysis for the integer matmul cores
(port of ``repro.analysis.bounds``).

Two integer facts carry the exactness of the quantized serving stack:

* ``int32 never wraps`` — a group's dot accumulates ``group_size``
  products of grid values of magnitude at most ``qmax_w * qmax_a``, so
  the worst case is ``peak = g * qmax(bits_w) * qmax(bits_a)`` and the
  kernel is safe iff ``peak < 2**31``. The W8A8 ``int8_matmul``
  accumulates the whole reduction axis in one int32, so there ``g = K``.
* ``the fp32 group fold is exact`` — ``qmm`` folds each group's int32
  dot into fp32, exact only while ``|dot| <= 2**24``. Past that the
  fold may round: not an overflow, and the cross-group sum is fp
  anyway, so this tier is a WARNING (W8 per-channel storage, one group
  spanning K, crosses it on every real config).

The kernels import the ``require_*`` validators, which raise instead of
returning findings. ``verify_configs`` is the CLI pass: for every
registered architecture it reads the matmul reduction dims of the
parameter tree built under a ``FakeTensorMode`` (shapes only, nothing
allocated) and proves the bounds for every width a ``QuantPolicy`` can
emit.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.qtensor import qmax_for_bits

INT32_LIMIT = 2**31          # int32 accumulator wraps at +/- 2^31
FP32_EXACT_LIMIT = 2**24     # largest contiguous exact integer range in fp32


def qmax(bits: int) -> int:
    return int(qmax_for_bits(bits))


def group_dot_peak(bits_w: int, bits_a: int, group_size: int) -> int:
    """Worst-case |int32 partial dot| over one scale group."""
    return group_size * qmax(bits_w) * qmax(bits_a)


def max_safe_group(bits_w: int, bits_a: int) -> int:
    """Largest group size whose worst-case dot stays below 2^31."""
    return (INT32_LIMIT - 1) // (qmax(bits_w) * qmax(bits_a))


def fp32_exact_group(bits_w: int, bits_a: int) -> int:
    """Largest group size whose worst-case dot casts to fp32 exactly."""
    return FP32_EXACT_LIMIT // (qmax(bits_w) * qmax(bits_a))


def check_group_dot(bits_w: int, bits_a: int, group_size: int,
                    where: str) -> List[Finding]:
    """Findings for one (bits_w, bits_a, group_size) grouped-dot shape."""
    peak = group_dot_peak(bits_w, bits_a, group_size)
    if peak >= INT32_LIMIT:
        return [Finding(
            "RPR201", "error", where,
            f"W{bits_w}A{bits_a} group_size={group_size}: worst-case group "
            f"dot {peak} >= 2^31 wraps int32; requantize with group_size "
            f"<= {max_safe_group(bits_w, bits_a)}")]
    if peak > FP32_EXACT_LIMIT:
        return [Finding(
            "RPR203", "warning", where,
            f"W{bits_w}A{bits_a} group_size={group_size}: worst-case group "
            f"dot {peak} > 2^24, so the fp32 scale fold may round "
            f"(exact-fold tier needs group_size <= "
            f"{fp32_exact_group(bits_w, bits_a)}); tolerated — the "
            "cross-group sum is fp anyway and the W8 per-channel contract "
            "relies on this granularity")]
    return []


def check_full_k(bits_w: int, bits_a: int, k: int, where: str) -> List[Finding]:
    """Findings for a full-K int32 accumulation (``int8_matmul``)."""
    peak = group_dot_peak(bits_w, bits_a, k)
    if peak >= INT32_LIMIT:
        return [Finding(
            "RPR202", "error", where,
            f"W{bits_w}A{bits_a} K={k}: worst-case full-K accumulator "
            f"{peak} >= 2^31 wraps int32 (safe K < "
            f"{max_safe_group(bits_w, bits_a) + 1})")]
    return []


# ---------------------------------------------------------------------------
# kernel-facing validators (raise instead of returning findings)
# ---------------------------------------------------------------------------

def require_group_dot_safe(bits_w: int, bits_a: int, group_size: int,
                           where: str) -> None:
    """Refuse a grouped quantized matmul whose int32 accumulator can wrap."""
    peak = group_dot_peak(bits_w, bits_a, group_size)
    if peak >= INT32_LIMIT:
        raise ValueError(
            f"{where}: W{bits_w}A{bits_a} group_size={group_size} can "
            f"overflow int32 (worst-case group dot {peak} >= 2^31, RPR201); "
            f"requantize with group_size <= {max_safe_group(bits_w, bits_a)}")


def require_full_k_safe(bits_w: int, bits_a: int, k: int, where: str) -> None:
    """Refuse a full-K int32 accumulation that can wrap (W8A8: K must
    stay at or below 133,144)."""
    peak = group_dot_peak(bits_w, bits_a, k)
    if peak >= INT32_LIMIT:
        raise ValueError(
            f"{where}: W{bits_w}A{bits_a} K={k} can overflow the int32 "
            f"accumulator (worst case {peak} >= 2^31, RPR202); safe only "
            f"for K <= {max_safe_group(bits_w, bits_a)}")


def require_act_alloc_sane(budget_bits: float, group_sizes: Sequence[float],
                           levels: Sequence[int], container_bits: int = 16,
                           where: str = "allocate_act_sites") -> None:
    """Static sanity for an activation-bit allocation problem."""
    if not (math.isfinite(budget_bits) and budget_bits > 0):
        raise ValueError(
            f"{where}: budget_bits must be finite and positive "
            f"(got {budget_bits!r})")
    for i, s in enumerate(group_sizes):
        if not (math.isfinite(float(s)) and float(s) > 0):
            raise ValueError(
                f"{where}: site group {i} has non-finite or non-positive "
                f"stored-element count {s!r}")
    for b in levels:
        if not (1 <= int(b) <= container_bits):
            raise ValueError(
                f"{where}: level {b} outside the storable container range "
                f"[1, {container_bits}]")


# ---------------------------------------------------------------------------
# whole-repo pass: prove the bounds for every config x policy bit level
# ---------------------------------------------------------------------------

def _stacked_name(name: str) -> str:
    """A leaf path without its layer indices (``layers/3/mlp/w_down`` ->
    ``layers/mlp/w_down``): the path of the block in every layer, as the
    reference's stacked parameter tree names it."""
    return "/".join(p for p in name.split("/") if not p.isdigit())


def _matmul_k_dims(arch: str) -> List[Tuple[str, int]]:
    """(stacked leaf path, reduction dim K) of every quantizable matmul
    block of ``arch``'s FULL config, from a parameter tree built under a
    ``FakeTensorMode``: shapes only, no weight is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.quantized import MATMUL_LEAVES
    from repro_torch.utils.pytree import named_leaves

    with FakeTensorMode():
        shapes = init_params(get_config(arch), device="cpu")
        leaves = [(name, tuple(leaf.shape)) for name, leaf in named_leaves(shapes)]
    out: List[Tuple[str, int]] = []
    for name, shape in leaves:
        if name.split("/")[-1] in MATMUL_LEAVES and len(shape) >= 2:
            # reduction axis is the second-to-last (qtensor pack default)
            out.append((_stacked_name(name), int(shape[-2])))
    return out


def verify_configs(archs: Optional[Iterable[str]] = None,
                   policy=None) -> List[Finding]:
    """Prove the accumulator bounds for every registered architecture.

    For each arch: every (weight bits emittable by ``policy``, A8) pair
    is checked at the coarsest granularity ``quantize_params`` can
    produce — ``group_size=None``, one group spanning the full reduction
    dim K — which dominates every finer grouping. The W8A8 full-K
    ``int8_matmul`` is checked at the same K. 8 activation bits is the
    engine's only dynamic activation grid.
    """
    from repro_torch.configs import ARCH_IDS
    from repro_torch.quant.policy import QuantPolicy

    policy = policy or QuantPolicy()
    w_levels = sorted({int(b) for b in policy.allowed_bits}
                      | {int(policy.pinned_bits)})
    findings: List[Finding] = []
    for arch in (archs or ARCH_IDS):
        seen_k: dict[int, str] = {}
        for name, k in _matmul_k_dims(arch):
            seen_k.setdefault(k, name)
        for k, example in sorted(seen_k.items()):
            for bw in w_levels:
                if bw >= 16:
                    continue
                where = f"{arch}:{example} (K={k})"
                findings.extend(check_group_dot(bw, 8, k, where))
                findings.extend(check_full_k(bw, 8, k, where))
    return findings


def run() -> List[Finding]:
    """CLI entry for the bounds pass (all archs, default policy)."""
    return verify_configs()
