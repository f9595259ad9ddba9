"""Forward-pass context: the single interception point for FIT and
quantized serving (port of ``repro.models.context``).

Every weight matmul calls ``ctx.matmul(name, x, w)`` and every
activation site ``ctx.tap(name, a)``; names are scoped with
``ctx.scope("layers/0")`` so paths line up with the parameter tree.

  * ``Context``         — identity (plain forward)
  * ``TapContext``      — adds a zero-valued tap tensor (FIT activation EF)
  * ``CollectContext``  — records activation values (shapes, ranges)
  * ``DequantContext``  — packed QTensor weights: ``matmul`` quantizes the
                          activation per row and runs the ``qmm`` kernel
                          (``int8_compute=True``) or dequantizes the weight
                          at the point of use; ``expert_matmul`` runs packed
                          MoE expert stacks through ``grouped_qmm``

The QAT, legacy int8 and tensor-parallel routes of the reference are
not ported yet.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional

import torch

from repro_torch.qtensor import QTensor, expert_slice


class Context:
    """Identity context (plain forward)."""

    def __init__(self, scope_prefix: str = ""):
        self._scope: List[str] = [scope_prefix] if scope_prefix else []

    @contextmanager
    def scope(self, name: str):
        self._scope.append(name)
        try:
            yield self
        finally:
            self._scope.pop()

    def path(self, name: str) -> str:
        return "/".join(self._scope + [name])

    def qw(self, name: str, w: torch.Tensor) -> torch.Tensor:
        return w

    def matmul(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        return x @ self.qw(name, w)

    def expert_matmul(self, name: str, buf: torch.Tensor, w,
                      counts: torch.Tensor) -> torch.Tensor:
        """The MoE expert-stack interception point. buf: (E, C, D)
        capacity-sorted segments (rows past ``counts[e]`` are zero); w:
        (E, D, F) stacked expert weights; counts: (E,) int32. Returns
        (E, C, F) with rows past the counts still zero. Default: the
        batched fp einsum over ``qw`` (zero rows in, zero rows out)."""
        del counts
        return torch.einsum("ecd,edf->ecf", buf, self.qw(name, w))

    def tap(self, name: str, a: torch.Tensor) -> torch.Tensor:
        return a


class TapContext(Context):
    """Add zero-valued tap tensors at activation sites (FIT activation EF)."""

    def __init__(self, taps: Mapping[str, torch.Tensor], scope_prefix: str = ""):
        super().__init__(scope_prefix)
        self.taps = taps

    def tap(self, name: str, a: torch.Tensor) -> torch.Tensor:
        t = self.taps.get(self.path(name))
        return a if t is None else a + t


class CollectContext(Context):
    """Record activation values (shape probes / calibration)."""

    def __init__(self, scope_prefix: str = ""):
        super().__init__(scope_prefix)
        self.acts: Dict[str, torch.Tensor] = {}

    def tap(self, name: str, a: torch.Tensor) -> torch.Tensor:
        self.acts[self.path(name)] = a
        return a


class DequantContext(Context):
    """Serve-time execution over packed QTensor weights.

    With ``int8_compute=True`` a 2-D QTensor block quantizes its input
    with a dynamic per-ROW scale and dispatches to ``ops.qmm``: row b's
    numerics depend only on row b, which keeps continuous-batching
    output bit-identical to isolated decode. Otherwise the weight is
    dequantized at the point of use.
    """

    def __init__(self, scales: Optional[Mapping[str, torch.Tensor]], dtype,
                 int8_compute: bool = False, moe_dispatch: str = "grouped",
                 scope_prefix: str = ""):
        super().__init__(scope_prefix)
        if scales:
            raise NotImplementedError(
                "legacy int8 leaves with path-keyed scales are not ported; "
                "use packed QTensor storage (serve.quantized.quantize_params)")
        if moe_dispatch not in ("grouped", "dense", "einsum"):
            raise ValueError(f"moe_dispatch must be grouped|dense|einsum, "
                             f"got {moe_dispatch!r}")
        self.dtype = dtype
        self.int8_compute = int8_compute
        self.moe_dispatch = moe_dispatch

    @staticmethod
    def _rowquant(x2: torch.Tensor):
        # x2 is fp32 (M, K); the division (not a reciprocal multiply) and
        # round-half-to-even match the reference grid exactly
        amax = torch.amax(torch.abs(x2), dim=-1, keepdim=True)
        xs = torch.clamp_min(amax, 1e-8) / 127.0
        xq = torch.clamp(torch.round(x2 / xs), -127, 127).to(torch.int8)
        return xq, xs

    def qw(self, name: str, w):
        if isinstance(w, QTensor):
            return w.dequantize(self.dtype)
        return w

    def matmul(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        from repro_torch.kernels import ops as kops
        if isinstance(w, QTensor):
            if not self.int8_compute or len(w.shape) != 2:
                return x @ w.dequantize(self.dtype)
            lead = x.shape[:-1]
            xq, xs = self._rowquant(x.reshape(-1, x.shape[-1]).to(torch.float32))
            y = kops.qmm(xq, w, xs, out_dtype=torch.float32)
            return y.to(self.dtype).reshape(lead + (w.shape[-1],))
        return x @ w

    def expert_matmul(self, name: str, buf: torch.Tensor, w,
                      counts: torch.Tensor) -> torch.Tensor:
        """Packed expert stacks go to the grouped ragged kernel
        (``moe_dispatch="grouped"``) or to the per-expert ``qmm`` loop
        (``"dense"``, the bit-identity oracle, masked to exact 0.0 past
        the counts); fp weights, shared-scale stacks and ``"einsum"``
        take the fp-dequant einsum. Rows are quantized with the same
        per-row scales as ``matmul``."""
        from repro_torch.kernels import ops as kops
        if (not isinstance(w, QTensor) or not self.int8_compute
                or len(w.shape) != 3 or self.moe_dispatch == "einsum"
                or w.scale.shape[0] != w.shape[0]):
            return super().expert_matmul(name, buf, w, counts)
        e, c, d = buf.shape
        xq, xs = self._rowquant(buf.reshape(-1, d).to(torch.float32))
        xq, xs = xq.reshape(e, c, d), xs.reshape(e, c, 1)
        cnt = counts.to(torch.int32)
        if self.moe_dispatch == "dense":
            y = torch.stack([kops.qmm(xq[i], expert_slice(w, i), xs[i])
                             for i in range(e)])
            rows = torch.arange(c, device=y.device)[None, :, None]
            y = torch.where(rows < cnt[:, None, None], y, torch.zeros_like(y))
        else:
            y = kops.grouped_qmm(xq, w, xs, cnt)
        return y.to(self.dtype)
