"""Worst-case integer bounds for the quantized matmul (port of the
validators in ``repro.analysis.bounds``).

A group's int32 dot accumulates ``group_size`` products of grid values
of magnitude at most ``qmax_w * qmax_a``; the kernel is safe iff that
peak stays below 2^31. The W8A8 ``int8_matmul`` accumulates the whole
reduction axis in one int32, so there K itself is the group.
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.qtensor import qmax_for_bits

INT32_LIMIT = 2**31


def qmax(bits: int) -> int:
    return int(qmax_for_bits(bits))


def group_dot_peak(bits_w: int, bits_a: int, group_size: int) -> int:
    """Worst-case |int32 partial dot| over one scale group."""
    return group_size * qmax(bits_w) * qmax(bits_a)


def max_safe_group(bits_w: int, bits_a: int) -> int:
    """Largest group size whose worst-case dot stays below 2^31."""
    return (INT32_LIMIT - 1) // (qmax(bits_w) * qmax(bits_a))


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
