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
                          at the point of use

The MoE, QAT, legacy int8 and tensor-parallel routes of the reference
are not ported yet.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional

import torch

from repro_torch.qtensor import QTensor


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
                 int8_compute: bool = False, scope_prefix: str = ""):
        super().__init__(scope_prefix)
        if scales:
            raise NotImplementedError(
                "legacy int8 leaves with path-keyed scales are not ported; "
                "use packed QTensor storage (serve.quantized.quantize_params)")
        self.dtype = dtype
        self.int8_compute = int8_compute

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
