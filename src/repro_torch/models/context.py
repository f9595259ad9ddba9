"""Forward-pass context: the single interception point for FIT and
quantized serving (port of ``repro.models.context``).

Every weight matmul calls ``ctx.matmul(name, x, w)`` and every
activation site ``ctx.tap(name, a)``; names are scoped with
``ctx.scope("layers/0")`` so paths line up with the parameter tree.

  * ``Context``         — identity (plain forward)
  * ``QATContext``      — STE fake-quant of weights and activations with
                          per-block levels (2^bits − 1), the QAT forward
  * ``TapContext``      — adds a zero-valued tap tensor (FIT activation EF)
  * ``CollectContext``  — records activation values (shapes, ranges)
  * ``DequantContext``  — quantized weights: packed QTensors (``matmul``
                          quantizes the activation per row and runs the
                          ``qmm`` kernel with ``int8_compute=True``, else
                          dequantizes at the point of use;
                          ``expert_matmul`` runs packed MoE expert stacks
                          through ``grouped_qmm``) or int8-backed leaves
                          with path-keyed scales (``int8_matmul``)

The tensor-parallel route of the reference is not ported yet.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional

import torch

from repro_torch.qtensor import QTensor, expert_slice


def _dynamic_fake_quant_ste(x: torch.Tensor, levels) -> torch.Tensor:
    """Min–max fake-quant of x with ``levels`` (2^b − 1, a float or a
    0-d tensor) and a straight-through gradient, as the reference's QAT
    forward computes it: the grid index is ``x / scale + zp`` (a
    division, unlike the fake-quant kernels), ``levels >= 32767`` is the
    identity (branch-free), and the STE is ``x + (y - x).detach()``.
    Plain PyTorch ops, not the fake-quant kernel: the reference's QAT
    path runs its own jnp arithmetic, not its kernel either."""
    lv = torch.as_tensor(levels, dtype=torch.float32, device=x.device)
    xd = x.detach()
    lo = torch.clamp_max(torch.amin(xd), 0.0).to(torch.float32)
    hi = torch.clamp_min(torch.amax(xd), 0.0).to(torch.float32)
    scale = torch.clamp_min((hi - lo) / lv, 1e-12)
    zp = torch.round(-lo / scale)
    q = torch.clamp(torch.round(xd.to(torch.float32) / scale + zp), 0.0)
    q = torch.minimum(q, lv)
    fq = ((q - zp) * scale).to(x.dtype)
    y = torch.where(lv >= 32767.0, xd, fq)
    return x + (y - x).detach()


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


class QATContext(Context):
    """Fake-quantize weights and activations with per-block levels.

    ``weight_levels`` / ``act_levels`` map block path -> levels
    (2^bits − 1), python floats or 0-d tensors (a slice of a per-layer
    levels table). A path not in a table falls back to its last part
    (shared-block invocations); a block in neither is left as it is.
    """

    def __init__(self, weight_levels: Mapping[str, Any],
                 act_levels: Mapping[str, Any], scope_prefix: str = ""):
        super().__init__(scope_prefix)
        self.weight_levels = weight_levels
        self.act_levels = act_levels

    def _lookup(self, table: Mapping[str, Any], path: str):
        if path in table:
            return table[path]
        return table.get(path.split("/")[-1])

    def qw(self, name: str, w: torch.Tensor) -> torch.Tensor:
        lv = self._lookup(self.weight_levels, self.path(name))
        return w if lv is None else _dynamic_fake_quant_ste(w, lv)

    def tap(self, name: str, a: torch.Tensor) -> torch.Tensor:
        lv = self._lookup(self.act_levels, self.path(name))
        return a if lv is None else _dynamic_fake_quant_ste(a, lv)


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
    """Serve-time execution over quantized weights, in one of two forms:
    packed QTensor leaves (``serve.quantized.quantize_params``, the
    ``qmm`` route) or int8-backed leaves with a path-keyed ``scales``
    dict (``quantize_params_int8``, the ``int8_matmul`` route).

    With ``int8_compute=True`` a 2-D block quantizes its input with a
    dynamic per-ROW scale and dispatches to the integer kernel: row b's
    numerics depend only on row b, which keeps continuous-batching
    output bit-identical to isolated decode. Otherwise the weight is
    dequantized at the point of use.
    """

    def __init__(self, scales: Optional[Mapping[str, torch.Tensor]], dtype,
                 int8_compute: bool = False, moe_dispatch: str = "grouped",
                 scope_prefix: str = ""):
        super().__init__(scope_prefix)
        self.scales = dict(scales) if scales else {}
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
        s = self.scales.get(self.path(name))
        if s is None or w.dtype != torch.int8:
            return w
        return (w.to(torch.float32) * s).to(self.dtype)

    def _rows_through(self, x: torch.Tensor, n: int, kernel) -> torch.Tensor:
        """Quantize x's rows and run ``kernel(xq, xs)`` -> (M, n) fp32."""
        lead = x.shape[:-1]
        xq, xs = self._rowquant(x.reshape(-1, x.shape[-1]).to(torch.float32))
        return kernel(xq, xs).to(self.dtype).reshape(lead + (n,))

    def matmul(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        from repro_torch.kernels import ops as kops
        if isinstance(w, QTensor):
            if not self.int8_compute or len(w.shape) != 2:
                return x @ w.dequantize(self.dtype)
            return self._rows_through(x, w.shape[-1],
                                      lambda xq, xs: kops.qmm(xq, w, xs))
        s = self.scales.get(self.path(name))
        if s is None or w.dtype != torch.int8:
            return x @ w
        if not self.int8_compute or w.ndim != 2:
            return x @ (w.to(torch.float32) * s).to(self.dtype)
        return self._rows_through(
            x, w.shape[-1],
            lambda xq, xs: kops.int8_matmul(xq, w, xs, s.reshape(1, -1)))

    def expert_matmul(self, name: str, buf: torch.Tensor, w,
                      counts: torch.Tensor) -> torch.Tensor:
        """Packed expert stacks go to the grouped ragged kernel
        (``moe_dispatch="grouped"``) or to the per-expert ``qmm`` loop
        (``"dense"``, the bit-identity oracle, masked to exact 0.0 past
        the counts); fp weights, shared-scale stacks, int8-backed stacks
        (dequantized by ``qw``) and ``"einsum"`` take the fp-dequant
        einsum. Rows are quantized with the same per-row scales as
        ``matmul``."""
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
