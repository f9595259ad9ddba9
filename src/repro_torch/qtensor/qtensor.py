"""QTensor: packed quantized-tensor storage (port of ``repro.qtensor``).

Byte layouts are identical to the reference, byte for byte:

  bits   payload             bytes/elem   grid
  16     (caller keeps fp)   2.0          —
  8      int8                1.0          ±127
  7, 5   int8 (grid-reduced) 1.0          ±63 / ±15
  6      3 bytes per 4 vals  0.75         ±31
  4      uint8 nibbles       0.5          ±7
  3      uint8 nibbles       0.5          ±3   (4-bit container)

Packing runs along ``axis``: 4/3-bit byte r holds element 2r in the low
nibble and 2r+1 in the high one; 6-bit packs 4 values little-endian into
3 bytes. Scales are fp32 with ``scale.ndim == len(shape)``; each dim is
1 (broadcast), full, or a divisor g (g contiguous groups).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

PACKED_BITS = (6, 4, 3)

# values-per-unit, bytes-per-unit of the packed byte layout
_UNITS = {6: (4, 3), 4: (2, 1), 3: (2, 1)}


def qmax_for_bits(bits: int) -> float:
    """Largest magnitude of the odd symmetric b-bit grid, 2^(b-1) - 1."""
    return float(2 ** (min(bits, 8) - 1) - 1)


def bytes_per_element(bits: int, fp_bytes: float = 2.0) -> float:
    """Realized storage bytes per logical element at ``bits``."""
    if bits >= 16:
        return float(fp_bytes)
    if bits in _UNITS:
        vals, nbytes = _UNITS[bits]
        return nbytes / vals
    return 1.0


def packed_size(n: int, bits: int) -> int:
    """Length of the packed axis for ``n`` logical elements."""
    if bits not in _UNITS:
        return n
    vals, nbytes = _UNITS[bits]
    return -(-n // vals) * nbytes


def logical_size(packed_n: int, bits: int) -> int:
    """Inverse of ``packed_size`` (exact when the axis was not padded)."""
    if bits not in _UNITS:
        return packed_n
    vals, nbytes = _UNITS[bits]
    return packed_n * vals // nbytes


def _pack_last(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 grid values -> packed uint8 bytes along the LAST axis."""
    vals, _ = _UNITS[bits]
    n = q.shape[-1]
    pad = (-n) % vals
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    u = q.to(torch.int32)
    if bits in (4, 3):
        lo, hi = u[..., 0::2] & 0xF, u[..., 1::2] & 0xF
        return (lo | (hi << 4)).to(torch.uint8)
    g = (u & 0x3F).reshape(u.shape[:-1] + ((n + pad) // 4, 4))
    v0, v1, v2, v3 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    b0 = v0 | ((v1 & 0x3) << 6)
    b1 = (v1 >> 2) | ((v2 & 0xF) << 4)
    b2 = (v2 >> 4) | (v3 << 2)
    out = torch.stack([b0, b1, b2], dim=-1)
    return out.reshape(u.shape[:-1] + (3 * (n + pad) // 4,)).to(torch.uint8)


def _unpack_last(p: torch.Tensor, bits: int,
                 n: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``_pack_last``; ``n`` trims padding."""
    u = p.to(torch.int32)
    if bits in (4, 3):
        v = torch.stack([u & 0xF, (u >> 4) & 0xF], dim=-1)
        v = v.reshape(u.shape[:-1] + (2 * u.shape[-1],))
        v = torch.where(v >= 8, v - 16, v)
    else:
        g = u.reshape(u.shape[:-1] + (u.shape[-1] // 3, 3))
        b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
        v0 = b0 & 0x3F
        v1 = ((b0 >> 6) & 0x3) | ((b1 & 0xF) << 2)
        v2 = ((b1 >> 4) & 0xF) | ((b2 & 0x3) << 4)
        v3 = (b2 >> 2) & 0x3F
        v = torch.stack([v0, v1, v2, v3], dim=-1)
        v = v.reshape(u.shape[:-1] + (4 * (u.shape[-1] // 3),))
        v = torch.where(v >= 32, v - 64, v)
    if n is not None:
        v = v[..., :n]
    return v.to(torch.int8)


def pack(q: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Pack int8 grid values into sub-byte storage along ``axis``
    (8/7/5 bits: a plain int8 cast)."""
    if bits not in _UNITS:
        return q.to(torch.int8)
    ax = axis % q.ndim
    if ax == q.ndim - 1:
        return _pack_last(q, bits)
    return torch.movedim(_pack_last(torch.movedim(q, ax, -1), bits), -1, ax)


def unpack(p: torch.Tensor, bits: int, size: Optional[int] = None,
           axis: int = -1) -> torch.Tensor:
    """Packed payload -> int8 grid values (inverse of ``pack``)."""
    if bits not in _UNITS:
        return p
    ax = axis % p.ndim
    if ax == p.ndim - 1:
        return _unpack_last(p, bits, size)
    return torch.movedim(_unpack_last(torch.movedim(p, ax, -1), bits, size),
                         -1, ax)


def unpack_rows(p: torch.Tensor, bits: int) -> torch.Tensor:
    """Axis-0 unpack of a 2-D (Kp, N) payload -> (K, N) int8 — the row
    interleave the ``qmm`` kernel performs in registers."""
    u = p.to(torch.int32)
    kp, n = u.shape
    if bits in (4, 3):
        v = torch.stack([u & 0xF, (u >> 4) & 0xF], dim=1).reshape(2 * kp, n)
        v = torch.where(v >= 8, v - 16, v)
    elif bits == 6:
        g = u.reshape(kp // 3, 3, n)
        b0, b1, b2 = g[:, 0], g[:, 1], g[:, 2]
        v0 = b0 & 0x3F
        v1 = ((b0 >> 6) & 0x3) | ((b1 & 0xF) << 2)
        v2 = ((b1 >> 4) & 0xF) | ((b2 & 0x3) << 4)
        v3 = (b2 >> 2) & 0x3F
        v = torch.stack([v0, v1, v2, v3], dim=1).reshape(4 * (kp // 3), n)
        v = torch.where(v >= 32, v - 64, v)
    else:
        return p
    return v.to(torch.int8)


def expand_scale(scale: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Grouped scale -> broadcastable view of ``shape`` (a divisor dim g
    repeats each scale over its contiguous group)."""
    s = scale
    for d, (sd, full) in enumerate(zip(s.shape, shape)):
        if sd not in (1, full):
            if full % sd:
                raise ValueError(
                    f"scale dim {d} ({sd}) does not divide logical {full}")
            s = torch.repeat_interleave(s, full // sd, dim=d)
    return s


@dataclasses.dataclass
class QTensor:
    """Packed quantized tensor (see module docstring)."""

    data: torch.Tensor       # packed payload (int8 or uint8)
    scale: torch.Tensor      # fp32, grouped per the module scale semantics
    bits: int
    shape: Tuple[int, ...]   # logical shape
    axis: int                # pack axis (normalized)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Payload bytes (scales excluded — see ``scale_bytes``)."""
        return self.data.numel() * self.data.element_size()

    @property
    def scale_bytes(self) -> int:
        return self.scale.numel() * 4

    @property
    def group_size(self) -> int:
        return self.shape[self.axis] // self.scale.shape[self.axis]

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scale.to(device), self.bits,
                       self.shape, self.axis)

    def unpack(self) -> torch.Tensor:
        return unpack(self.data, self.bits, self.shape[self.axis], self.axis)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        q = self.unpack()
        s = expand_scale(self.scale, self.shape)
        return (q.to(torch.float32) * s).to(dtype)


def quantize_values(x: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """``clip(round(x / scale), ±qmax)`` as int8 (round half to even)."""
    qmax = qmax_for_bits(bits)
    x32 = x.to(torch.float32)
    return torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int8)


def quantize(x: torch.Tensor, bits: int, group_size: Optional[int] = None,
             axis: Optional[int] = None,
             scale: Optional[torch.Tensor] = None) -> QTensor:
    """Symmetric per-(group, out-channel) quantization -> packed QTensor.
    The out-channel is the last axis; groups run along ``axis`` (default
    the second-to-last, the matmul reduction axis)."""
    if x.ndim < 2:
        raise ValueError("QTensor quantization needs a matrix-like input "
                         f"(got shape {tuple(x.shape)}); vectors stay fp")
    ax = (x.ndim - 2 if axis is None else axis % x.ndim)
    if ax == x.ndim - 1:
        raise ValueError("pack axis cannot be the out-channel (last) axis")
    k = x.shape[ax]
    gs = k if group_size is None else min(group_size, k)
    if k % gs:
        raise ValueError(f"group_size {gs} does not divide axis {ax} ({k})")
    if bits in _UNITS:
        if k % _UNITS[bits][0]:
            raise ValueError(
                f"{bits}-bit packing needs axis {ax} ({k}) divisible by "
                f"{_UNITS[bits][0]}")
        if gs % _UNITS[bits][0]:
            raise ValueError(
                f"group_size {gs} must be a multiple of the {bits}-bit "
                f"pack unit ({_UNITS[bits][0]})")
    qmax = qmax_for_bits(bits)
    x32 = x.to(torch.float32)
    if scale is None:
        a = torch.movedim(x32.abs(), ax, 0)
        a = a.reshape((k // gs, gs) + tuple(a.shape[1:]))
        red = tuple(range(1, a.ndim - 1))
        amax = torch.amax(a, dim=red)                 # (G, C)
        sshape = [1] * x.ndim
        sshape[ax], sshape[-1] = k // gs, x.shape[-1]
        scale = (torch.clamp_min(amax, 1e-12) / qmax).reshape(sshape)
    q = quantize_values(x32, expand_scale(scale, tuple(x.shape)), bits)
    # packing along a non-last axis goes through a transposed view; store
    # the payload contiguous so kernels never copy it per call
    return QTensor(pack(q, bits, ax).contiguous(), scale.to(torch.float32),
                   bits, tuple(x.shape), ax)


def quantize_experts(x: torch.Tensor, bits: int,
                     group_size: Optional[int] = None) -> QTensor:
    """Quantize a stacked expert weight (E, K, N) with PER-EXPERT
    per-(group, out-channel) scales (E, G, N), packed along K (axis 1):
    ``expert_slice(qt, e)`` is ``quantize(x[e], bits, group_size)`` bit
    for bit, so every expert is a self-contained ``qmm`` block."""
    if x.ndim != 3:
        raise ValueError(f"expert stacks are 3-D (E, K, N); got {tuple(x.shape)}")
    e, k, n = x.shape
    gs = k if group_size is None else min(group_size, k)
    if k % gs:
        raise ValueError(f"group_size {gs} does not divide K ({k})")
    if bits in _UNITS:
        if k % _UNITS[bits][0]:
            raise ValueError(
                f"{bits}-bit packing needs K ({k}) divisible by "
                f"{_UNITS[bits][0]}")
        if gs % _UNITS[bits][0]:
            raise ValueError(
                f"group_size {gs} must be a multiple of the {bits}-bit "
                f"pack unit ({_UNITS[bits][0]})")
    qmax = qmax_for_bits(bits)
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32).reshape(e, k // gs, gs, n), dim=2)
    scale = (torch.clamp_min(amax, 1e-12) / qmax).to(torch.float32)
    q = quantize_values(x32, expand_scale(scale, tuple(x.shape)), bits)
    return QTensor(pack(q, bits, 1).contiguous(), scale, bits,
                   tuple(x.shape), 1)


def expert_slice(qt: QTensor, e: int) -> QTensor:
    """Expert ``e`` of a ``quantize_experts`` stack as a 2-D (K, N)
    QTensor: a pure slice of payload and scales (a shared-scale stack
    hands every expert its one scale grid)."""
    if qt.ndim != 3:
        raise ValueError(f"expert_slice needs a 3-D QTensor; got {qt.shape}")
    scale = qt.scale[e] if qt.scale.shape[0] == qt.shape[0] else qt.scale[0]
    return QTensor(qt.data[e], scale, qt.bits, qt.shape[1:],
                   qt.axis - 1 if qt.axis else 0)


def pack_unit(bits: int) -> int:
    """Logical elements per indivisible pack unit (1 for unpacked widths)."""
    return _UNITS[bits][0] if bits in _UNITS else 1


def shard_error(qt: QTensor, n: int, axis: int) -> Optional[str]:
    """Why ``qt`` cannot be split into ``n`` equal shards along logical
    ``axis``, or None if it can. The logical dim must divide into n;
    on the pack axis a shard must own whole pack units (the 6-bit
    4-values-in-3-bytes unit is the sharp case) and whole scale groups,
    so each shard dequantizes with its own group-scale rows; on any
    other axis a grouped scale dim must itself split evenly."""
    ax = axis % qt.ndim
    d = qt.shape[ax]
    if n < 1:
        return f"shard count must be >= 1 (got {n})"
    if d % n:
        return f"logical dim {ax} ({d}) does not divide into {n} shards"
    span = d // n
    if ax == qt.axis:
        unit = pack_unit(qt.bits)
        if span % unit:
            return (f"shard span {span} splits a {qt.bits}-bit pack unit "
                    f"({unit} values) on the pack axis")
        g = qt.scale.shape[ax]
        if g not in (1, d) and g % n:
            return (f"{g} scale groups do not align with {n} shard "
                    "boundaries on the pack axis")
        if g == 1 and n > 1:
            return ("a single scale group spans the whole pack axis and "
                    "cannot be split — requantize with group boundaries "
                    "aligned to shard boundaries (group_size a divisor "
                    f"of {span})")
    else:
        sd = qt.scale.shape[ax]
        if sd not in (1, d) and sd % n:
            return (f"scale dim {ax} ({sd} groups) does not divide into "
                    f"{n} shards")
    return None


def shard(qt: QTensor, n: int, axis: int) -> Tuple[QTensor, ...]:
    """Split ``qt`` into ``n`` self-contained QTensors along logical
    ``axis``: each shard owns ``packed_size(span)`` payload rows on the
    pack axis (``span`` elsewhere) and its slice of the grouped scales
    (G/n rows; a broadcast scale dim is kept whole). Views of ``qt``;
    concatenating the shards' dequantized values gives ``qt``'s."""
    err = shard_error(qt, n, axis)
    if err:
        raise ValueError(f"cannot shard QTensor{qt.shape} {qt.bits}-bit "
                         f"x{n} on axis {axis}: {err}")
    ax = axis % qt.ndim
    span = qt.shape[ax] // n
    dspan = qt.data.shape[ax] // n
    sd = qt.scale.shape[ax]
    sspan = sd // n if sd > 1 else 0
    shape = list(qt.shape)
    shape[ax] = span
    out = []
    for i in range(n):
        data = qt.data.narrow(ax, i * dspan, dspan)
        scale = qt.scale.narrow(ax, i * sspan, sspan) if sspan else qt.scale
        out.append(QTensor(data, scale, qt.bits, tuple(shape), qt.axis))
    return tuple(out)


def is_qtensor(x: Any) -> bool:
    return isinstance(x, QTensor)


def _leaves(tree: Any):
    from repro_torch.utils.pytree import named_leaves
    return [leaf for _, leaf in named_leaves(tree)]


def tree_has_qtensor(tree: Any) -> bool:
    return any(isinstance(leaf, QTensor) for leaf in _leaves(tree))


def storage_summary(tree: Any) -> dict:
    """Byte accounting of a tree's QTensor blocks (packed, int8-backed,
    fp16, the BitConfig's predicted bytes, and a bits histogram)."""
    out = {"packed_bytes": 0.0, "int8_backed_bytes": 0.0, "fp16_bytes": 0.0,
           "predicted_bytes": 0.0, "bit_histogram": {}}
    for leaf in _leaves(tree):
        if not isinstance(leaf, QTensor):
            continue
        elems = 1.0
        for d in leaf.shape:
            elems *= d
        out["packed_bytes"] += leaf.nbytes + leaf.scale_bytes
        out["int8_backed_bytes"] += elems + leaf.scale_bytes
        out["fp16_bytes"] += 2 * elems
        out["predicted_bytes"] += leaf.bits * elems / 8
        out["bit_histogram"][leaf.bits] = \
            out["bit_histogram"].get(leaf.bits, 0) + 1
    return out


def tree_payload_bytes(tree: Any) -> int:
    """Storage bytes of a tree: QTensors packed, tensors at dtype size."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes + leaf.scale_bytes
        else:
            total += leaf.numel() * leaf.element_size()
    return total
