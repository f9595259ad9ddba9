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
  * ``RecordTaps``      — records the tap values of any wrapped context,
                          leaving its matmul routing as it is (the drift
                          monitor's probe of the serving context)
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
  * ``MeshContext``     — one data row of a (data, model) ``Mesh``: fp,
                          QAT or int8-backed weights laid out by
                          ``launch.sharding`` (training, prefill and the
                          decode step of ``launch.steps``)
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional

import torch

from repro_torch.qtensor import QTensor, expert_slice


def _dynamic_fake_quant_ste(x: torch.Tensor, levels, lo=None,
                            hi=None) -> torch.Tensor:
    """Min–max fake-quant of x with ``levels`` (2^b − 1, a float or a
    0-d tensor) and a straight-through gradient, as the reference's QAT
    forward computes it: the grid index is ``x / scale + zp`` (a
    division, unlike the fake-quant kernels), ``levels >= 32767`` is the
    identity (branch-free), and the STE is ``x + (y - x).detach()``.
    ``lo`` / ``hi`` (0-d fp32) give the range when x is one shard of a
    weight: the grid of the whole tensor. Plain PyTorch ops, not the
    fake-quant kernel: the reference's QAT path runs its own jnp
    arithmetic, not its kernel either."""
    lv = torch.as_tensor(levels, dtype=torch.float32, device=x.device)
    xd = x.detach()
    if lo is None:
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

    @contextmanager
    def restored(self, stack: List[str]):
        """Run under the scope stack ``stack``: a block rematerialized in
        the backward recomputes under the scopes its forward saw."""
        outer, self._scope = self._scope, list(stack)
        try:
            yield self
        finally:
            self._scope = outer

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


class RecordTaps:
    """Delegating wrapper that records every ``tap`` site's value while
    leaving all other context behavior (scoping, matmul routing, weight
    handling) to the wrapped context.

    ``obs.drift`` uses this to collect the QUANTIZED engine's activation
    taps (e.g. ``router_logits``) through the engine's own
    ``DequantContext`` — ``CollectContext`` can't, because it would also
    replace the quantized matmul routing being probed.
    """

    def __init__(self, inner: Context):
        self._inner = inner
        self.acts: Dict[str, torch.Tensor] = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @contextmanager
    def scope(self, name: str):
        with self._inner.scope(name):
            yield self

    def tap(self, name: str, a: torch.Tensor) -> torch.Tensor:
        a = self._inner.tap(name, a)
        self.acts[self._inner.path(name)] = a
        return a


def _emit_replicated(calls: str, xq: torch.Tensor) -> None:
    """A sharded block's counters, from its REPLICATED pre-shard int8
    activation (the same at every tp): one call, and on a sampled burst
    its saturation. The per-shard kernel calls run ``suspended``."""
    from repro_torch.kernels.qmm import saturation_stats
    from repro_torch.obs import runtime as obs_rt
    if obs_rt.emitting():
        obs_rt.emit(calls, 1.0)
        if obs_rt.emitting_stats():
            sat, total = saturation_stats(xq)
            obs_rt.emit("act_sat", sat)
            obs_rt.emit("act_elems", total)


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
        # rpr-ok: RPR002 int32 full-K dots of disjoint K slices: integer adds are exact
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
        from repro_torch.obs import runtime as obs_rt
        parts = self._blocks[path]
        lead = x.shape[:-1]
        xq, xs = self._rowquant(x.reshape(-1, x.shape[-1]).to(torch.float32))
        xs = xs.reshape(-1)
        _emit_replicated("qmm_calls" if isinstance(w, QTensor)
                         else "int8mm_calls", xq)
        with obs_rt.suspended():
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
        from repro_torch.obs import runtime as obs_rt
        parts = self._blocks[self.path(name)]
        e, c, d = buf.shape
        xq, xs = self._rowquant(buf.reshape(-1, d).to(torch.float32))
        _emit_replicated("qmm_calls", xq)
        xq, xs = xq.reshape(e, c, d), xs.reshape(e, c, 1)
        cnt = counts.to(torch.int32)
        el = e // len(parts)
        with obs_rt.suspended():
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


# weight blocks ``MeshContext`` routes (``ctx.matmul`` / ``expert_matmul``
# / ``qw``); every other leaf the model reads as it is
ROUTED = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "wz", "wx",
          "wB", "wC", "wdt", "out_proj", "head", "router")


class MeshContext(QATContext):
    """One data row of a (data, model) ``launch.mesh.Mesh``: the
    training and prefill counterpart of ``ShardedDequantContext`` (also
    the mesh decode step's), standing where the reference's step
    functions lay weights out by ``launch.sharding``'s specs. ``lead`` is the coordinate of the row's
    lead shard, where the row's activations live: they stay replicated
    within the row between blocks. ``shards`` maps a block's ``ctx``
    path to its ``launch.mesh.ShardedTensor`` (laid out by
    ``launch.sharding.param_pspecs``).

    ``matmul`` by the weight's spec ("tp" strategy):

      * last dim over "model" (column block): each model shard computes
        its output columns from the whole input; the columns are
        all-gathered;
      * dim −2 over "model" (row block): each shard multiplies its slice
        of the input's last dim; the fp partials are ``psum``'d in shard
        order;
      * replicated: the whole product on the lead shard;
      * any other layout, and every sharded weight under ``"fsdp"``: the
        weight is all-gathered at use and the product is whole.

    ``expert_matmul`` treats an (E, d_in, d_out) stack the same way on
    its last two dims (MoE-TP splits the expert hidden dim); an
    expert-sharded stack is ``models.moe.moe_apply_ep``'s and is
    gathered here only when EP is off.

    Weights pass through ``qw`` shard by shard: QAT levels
    (``weight_levels``/``act_levels``, full block paths) fake-quantize
    each shard on the grid of the WHOLE weight (its min and max taken
    over the shards with ``pmax``), so a shard sees the values of the
    unsharded QAT forward; int8-backed leaves with ``scales`` (by block
    path) dequantize with their per-block scale. Activation taps run on
    the replicated activations, as unsharded.
    """

    def __init__(self, mesh, lead, shards: Mapping[str, Any],
                 strategy: str = "tp",
                 weight_levels: Optional[Mapping[str, Any]] = None,
                 act_levels: Optional[Mapping[str, Any]] = None,
                 scales: Optional[Mapping[str, torch.Tensor]] = None,
                 dtype=None, scope_prefix: str = ""):
        super().__init__(weight_levels or {}, act_levels or {}, scope_prefix)
        if strategy not in ("tp", "fsdp"):
            raise ValueError(f"strategy must be tp|fsdp, got {strategy!r}")
        self.mesh = mesh
        self.lead = tuple(lead)
        self.shards = dict(shards)
        self.strategy = strategy
        self.scales = dict(scales) if scales else {}
        self.dtype = dtype
        self.row = (next(g for g in mesh.groups(mesh.coords(), "model")
                         if self.lead in g)
                    if "model" in mesh.shape else [self.lead])

    @property
    def device(self) -> torch.device:
        return self.mesh.device(self.lead)

    def leaf(self, path: str):
        """The sharded leaf at a block path (a hybrid's shared block is
        stored once, whatever its application's scope)."""
        st = self.shards.get(path)
        if st is None:
            st = self.shards.get(re.sub(r"(^|/)shared/\d+/", r"\1shared/", path))
        return st

    @staticmethod
    def model_dim(st) -> Optional[int]:
        """The dim of ``st`` split over "model" (None: replicated)."""
        return st.axis_dim("model")

    def _range(self, st):
        """(lo, hi) of the whole weight over the row's shards."""
        if self.model_dim(st) is None:
            w = st.parts[self.lead].detach()
            return (torch.clamp_max(torch.amin(w), 0.0).to(torch.float32),
                    torch.clamp_min(torch.amax(w), 0.0).to(torch.float32))
        neg = {c: -torch.amin(st.parts[c].detach()).to(torch.float32)
               for c in self.row}
        pos = {c: torch.amax(st.parts[c].detach()).to(torch.float32)
               for c in self.row}
        lo = -self.mesh.pmax(neg, "model")[self.lead]
        hi = self.mesh.pmax(pos, "model")[self.lead]
        return torch.clamp_max(lo, 0.0), torch.clamp_min(hi, 0.0)

    def _transform(self, path: str, st):
        """The weight transform of the block at ``path``, applied to each
        of its parts: the int8 dequant, QAT's fake quant on the whole
        weight's grid, or None (the parts as they are)."""
        s = self.scales.get(path)
        if s is not None and st.dtype == torch.int8:
            return lambda w: (w.to(torch.float32) * s.to(w.device)).to(self.dtype)
        lv = self._lookup(self.weight_levels, path)
        if lv is None:
            return None
        lo, hi = self._range(st)
        return lambda w: _dynamic_fake_quant_ste(
            w, torch.as_tensor(lv).to(w.device), lo.to(w.device), hi.to(w.device))

    def parts(self, path: str, st, coords=None) -> Dict[Any, torch.Tensor]:
        """The (transformed) parts of the block at ``path`` on ``coords``
        (default: the row's shards)."""
        f = self._transform(path, st)
        cs = self.row if coords is None else coords
        return {c: st.parts[c] if f is None else f(st.parts[c]) for c in cs}

    def whole(self, path: str, st) -> torch.Tensor:
        """The whole (transformed) weight on the lead shard: its lead part
        when replicated over "model", else all-gathered at use."""
        dim = self.model_dim(st)
        if dim is None:
            return self.parts(path, st, [self.lead])[self.lead]
        return self.mesh.all_gather(self.parts(path, st), "model",
                                    dim=dim)[self.lead]

    def _mode(self, st) -> str:
        dim = self.model_dim(st)
        if dim is None:
            return "whole"
        if self.strategy == "tp" and dim == st.ndim - 1:
            return "col"
        if self.strategy == "tp" and dim == st.ndim - 2:
            return "row"
        return "gather"

    def qw(self, name: str, w):
        path = self.path(name)
        st = self.leaf(path)
        return w if st is None else self.whole(path, st)

    def _product(self, path, st, x, op):
        mode = self._mode(st)
        if mode in ("whole", "gather"):
            return op(x, self.whole(path, st))
        parts = self.parts(path, st)
        if mode == "col":
            ys = {c: op(x.to(w.device), w) for c, w in parts.items()}
            return self.mesh.all_gather(ys, "model", dim=-1)[self.lead]
        kl = st.shape[-2] // len(self.row)
        ys = {c: op(x[..., i * kl:(i + 1) * kl].to(parts[c].device), parts[c])
              for i, c in enumerate(self.row)}
        # rpr-ok: RPR002 training-path fp partials of disjoint K slices, folded in shard order (not under the serving exactness contract)
        return self.mesh.psum(ys, "model")[self.lead]

    def matmul(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        path = self.path(name)
        st = self.leaf(path)
        if st is None:
            return super().matmul(name, x, w)
        return self._product(path, st, x, lambda a, b: a @ b)

    def expert_matmul(self, name: str, buf: torch.Tensor, w,
                      counts: torch.Tensor) -> torch.Tensor:
        path = self.path(name)
        st = self.leaf(path)
        if st is None:
            return super().expert_matmul(name, buf, w, counts)
        return self._product(path, st, buf,
                             lambda a, b: torch.einsum("ecd,edf->ecf", a, b))

    def expert_slab(self, name: str, c) -> torch.Tensor:
        """Model shard ``c``'s slab of the expert stack ``name``: its part
        when the stack is split over experts, else its experts' rows of
        the gathered stack."""
        path = self.path(name)
        st = self.leaf(path)
        e_dim = st.ndim - 3
        if self.model_dim(st) == e_dim:
            return self.parts(path, st, [c])[c]
        full = self.whole(path, st)
        el = full.shape[e_dim] // len(self.row)
        i = self.row.index(c)
        return full.narrow(e_dim, i * el, el).to(self.mesh.device(c))

    def shard_weight(self, name: str, c, dim: int) -> torch.Tensor:
        """Model shard ``c``'s slice along ``dim`` of the 2-D weight
        ``name`` (its part when so laid out, else cut from the gathered
        weight)."""
        path = self.path(name)
        st = self.leaf(path)
        if self.model_dim(st) == dim:
            return self.parts(path, st, [c])[c]
        full = self.whole(path, st)
        n = full.shape[dim] // len(self.row)
        i = self.row.index(c)
        return full.narrow(dim, i * n, n).to(self.mesh.device(c))


class ShardedRows:
    """An embedding table split over "model" on its last dim, as the
    model reads it: ``table[ids]`` looks each shard's slice up on its
    device and all-gathers the (..., D/m) rows; ``table[cb]`` (an int,
    the audio family's codebook) selects a sub-table."""

    def __init__(self, ctx: MeshContext, parts: Dict[Any, torch.Tensor]):
        self._ctx = ctx
        self._parts = parts

    @property
    def dtype(self):
        return next(iter(self._parts.values())).dtype

    @property
    def device(self) -> torch.device:
        return self._ctx.device

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return ShardedRows(self._ctx, {c: p[idx] for c, p in self._parts.items()})
        rows = {c: p[idx.to(p.device)] for c, p in self._parts.items()}
        return self._ctx.mesh.all_gather(rows, "model", dim=-1)[self._ctx.lead]
