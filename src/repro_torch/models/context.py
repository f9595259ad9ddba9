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
  * ``ShardedDequantContext`` — ``DequantContext`` over a tensor-parallel
                          ``TPMesh``: the blocks of a shard plan run
                          shard-local kernels, combined exactly
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

    def rows_exact(self, name: str, w) -> bool:
        """Whether ``matmul(name, x, w)`` gives a row of x the same bits
        whatever the number of rows. A library GEMM may split its
        reduction by the row count, so only the integer kernel routes
        (exact int32 dots, a fixed fold per element) say yes."""
        return False


class ColumnContext:
    """``ctx`` seen by a (B, T, ·) decode call with T > 1: ``matmul``
    runs one call a query column where the route is not row-exact
    (``rows_exact``), so every column gets the bits of a one-token step;
    row-exact blocks stay one fused call. Everything else is ``ctx``'s
    own (its scope stack included)."""

    def __init__(self, ctx: Context):
        self._ctx = ctx

    def __getattr__(self, name: str):
        return getattr(self._ctx, name)

    def matmul(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        ctx = self._ctx
        if x.ndim != 3 or x.shape[1] == 1 or ctx.rows_exact(name, w):
            return ctx.matmul(name, x, w)
        return torch.cat([ctx.matmul(name, x[:, j:j + 1].contiguous(), w)
                          for j in range(x.shape[1])], dim=1)


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

    def rows_exact(self, name: str, w) -> bool:
        if not self.int8_compute:
            return False
        if isinstance(w, QTensor):
            return len(w.shape) == 2
        return (self.scales.get(self.path(name)) is not None
                and w.dtype == torch.int8 and w.ndim == 2)

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


class ShardedDequantContext(DequantContext):
    """Tensor-parallel ``DequantContext`` (port of the reference's
    ``ShardedDequantContext``): the blocks of ``shard_plan`` (from
    ``serve.quantized.shard_params``) run shard-local kernels on each
    device of a ``launch.mesh.TPMesh``; unplanned blocks fall through
    to the parent on the lead device. Activations stay replicated
    between blocks, so the per-row activation quantization sees the
    same full rows at every tp degree.

    Why the result equals tp=1 bit for bit:

      * "col" — a shard computes its output columns with the whole
        reduction axis; every op after the integer dot is elementwise
        per column, so the all-gather concatenates tp=1's values;
      * "row" — a shard owns whole scale groups; its terms
        ``f32(int32 dot) * w_scale[g]`` (``qmm_groups``) are exact and
        shard-invariant; gathered in group order they are the tp=1
        kernel's terms, and ``qmm_groups_fold`` folds them with the
        ``qmm`` kernel's arithmetic, in its order. (The reference psums
        zero-padded group slots, which is this concatenation, and then
        sums with ``jnp.sum``, which matches its tp=1 kernel only on
        the oracle route.) Int8-backed row blocks add the shards' int32
        accumulators (exact) before the ``int8_matmul`` epilogue;
      * "ep" — a shard runs ``grouped_qmm`` over its experts' segments
        of the replicated capacity buffer; each expert's rows are
        computed by one shard with the unsharded call's arithmetic.

    Only the integer route has these exact combines, so a quantized
    tree needs ``int8_compute=True`` (the engine enforces it).
    """

    def __init__(self, shard_trees: List[Any],
                 shard_scales: List[Mapping[str, torch.Tensor]], dtype,
                 mesh, shard_plan: Mapping[str, str],
                 int8_compute: bool = True, moe_dispatch: str = "grouped",
                 scope_prefix: str = ""):
        super().__init__(shard_scales[0], dtype, int8_compute=int8_compute,
                         moe_dispatch=moe_dispatch, scope_prefix=scope_prefix)
        from repro_torch.serve.quantized import qw_path
        from repro_torch.utils.pytree import named_leaves

        self.mesh = mesh
        self.shard_plan = dict(shard_plan)
        # planned block path -> its per-shard leaves and int8 scales
        self._blocks: Dict[str, List[Any]] = {}
        for i, tree in enumerate(shard_trees):
            for name, leaf in named_leaves(tree):
                if qw_path(name) in self.shard_plan:
                    self._blocks.setdefault(qw_path(name), []).append(leaf)
        self._scales = {key: [sc[key] for sc in shard_scales]
                        for key in self.shard_plan if key in shard_scales[0]}

    def _on(self, t: torch.Tensor, i: int) -> torch.Tensor:
        return t.to(self.mesh.devices[i])

    # -- shard-local products, combined on the lead device ---------------
    def _qmm_col(self, xq, xs, parts):
        from repro_torch.kernels import ops as kops
        return self.mesh.all_gather(
            [kops.qmm(self._on(xq, i), w, self._on(xs, i))
             for i, w in enumerate(parts)], dim=1)

    def _qmm_row(self, xq, xs, parts):
        from repro_torch.kernels import ops as kops
        kl = parts[0].shape[0]
        terms = [kops.qmm_group_products(
                     self._on(xq[:, i * kl:(i + 1) * kl], i), w)
                 for i, w in enumerate(parts)]
        return kops.fold_group_terms(self.mesh.all_gather(terms, dim=0), xs)

    def _int8_col(self, xq, xs, parts, scales):
        from repro_torch.kernels import ops as kops
        return self.mesh.all_gather(
            [kops.int8_matmul(self._on(xq, i), w, self._on(xs, i),
                              s.reshape(1, -1))
             for i, (w, s) in enumerate(zip(parts, scales))], dim=1)

    def _int8_row(self, xq, xs, parts, scales):
        kl = parts[0].shape[0]
        acc = self.mesh.psum(
            [_int32_dots(self._on(xq[:, i * kl:(i + 1) * kl], i), w)
             for i, w in enumerate(parts)])
        # the elementwise epilogue of the int8_matmul kernel, in its order
        return (acc.to(torch.float32) * xs.reshape(-1, 1)) \
            * scales[0].reshape(1, -1)

    # -- dispatch ----------------------------------------------------------
    def rows_exact(self, name: str, w) -> bool:
        # planned blocks are quantized and combine exactly (see above)
        return (self.shard_plan.get(self.path(name)) in ("col", "row")
                or super().rows_exact(name, w))

    def matmul(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        path = self.path(name)
        mode = self.shard_plan.get(path)
        if mode is None:
            return super().matmul(name, x, w)
        parts = self._blocks[path]
        lead = x.shape[:-1]
        xq, xs = self._rowquant(x.reshape(-1, x.shape[-1]).to(torch.float32))
        xs = xs.reshape(-1)
        if isinstance(w, QTensor):
            y = (self._qmm_col(xq, xs, parts) if mode == "col"
                 else self._qmm_row(xq, xs, parts))
        elif mode == "col":
            y = self._int8_col(xq, xs, parts, self._scales[path])
        else:
            y = self._int8_row(xq, xs, parts, self._scales[path])
        return y.to(self.dtype).reshape(lead + (y.shape[-1],))

    def expert_matmul(self, name: str, buf: torch.Tensor, w,
                      counts: torch.Tensor) -> torch.Tensor:
        """Blocks planned "ep" run ``grouped_qmm`` per shard over its
        experts' segments (tokens are replicated, so the all-to-all of
        the classical layout is a local slice) and gather the expert
        outputs in expert order; everything else falls through to the
        parent's replicated dispatch."""
        if (self.shard_plan.get(self.path(name)) != "ep"
                or self.moe_dispatch == "einsum"):
            return super().expert_matmul(name, buf, w, counts)
        from repro_torch.kernels import ops as kops
        parts = self._blocks[self.path(name)]
        e, c, d = buf.shape
        xq, xs = self._rowquant(buf.reshape(-1, d).to(torch.float32))
        xq, xs = xq.reshape(e, c, d), xs.reshape(e, c, 1)
        cnt = counts.to(torch.int32)
        el = e // len(parts)
        ys = [kops.grouped_qmm(self._on(xq[i * el:(i + 1) * el], i), wl,
                               self._on(xs[i * el:(i + 1) * el], i),
                               self._on(cnt[i * el:(i + 1) * el], i))
              for i, wl in enumerate(parts)]
        return self.mesh.all_gather(ys, dim=0).to(self.dtype)


def _int32_dots(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact (M, N) int32 dots of (M, K) int8 x (K, N) int8: the plain
    version on the CPU, ``torch._int_mm`` on CUDA (rows padded to 32,
    the smallest M it takes, where K and N suit it). Outside any kernel
    in the reference too: a plain ``dot_general``."""
    from repro_torch.kernels.ref import int8_dots
    m, k = xq.shape
    if xq.device.type != "cuda" or k % 8 or w.shape[1] % 8:
        return int8_dots(xq, w)
    mp = max(32, -(-m // 8) * 8)
    xp = torch.zeros((mp, k), dtype=torch.int8, device=xq.device)
    xp[:m] = xq
    return torch._int_mm(xp, w)[:m]
