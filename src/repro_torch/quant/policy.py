"""Layer-wise quantization policies (copy of ``repro.quant.policy``).

A ``BitConfig`` maps block path -> bits, separately for weights and
activation sites. ``QuantPolicy`` adds structural rules (pin routers /
norms / embeddings to high precision, default bits, allowed bit set).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

# Block-name substrings never quantized below 8 bits by default: routing
# logits are brittle (top-k flips), norm scales are tiny vectors with
# outsized effect, and the final logits layer controls the loss scale.
DEFAULT_PINNED = ("router", "gate_w", "norm", "ln", "scale", "embed_frontend")


@dataclasses.dataclass
class BitConfig:
    """One concrete MPQ configuration."""

    weight_bits: Dict[str, int]
    act_bits: Dict[str, int]

    def flat(self) -> Dict[str, int]:
        out = {f"W:{k}": v for k, v in self.weight_bits.items()}
        out.update({f"A:{k}": v for k, v in self.act_bits.items()})
        return out

    def model_bits(self, param_sizes: Dict[str, int]) -> float:
        """Total weight storage in bits under this config."""
        return float(
            sum(param_sizes[k] * self.weight_bits.get(k, 16) for k in param_sizes)
        )


@dataclasses.dataclass
class QuantPolicy:
    """Structural rules for generating / sanitizing bit configurations."""

    allowed_bits: Sequence[int] = (8, 6, 4, 3)
    default_weight_bits: int = 8
    default_act_bits: int = 8
    pinned_substrings: Sequence[str] = DEFAULT_PINNED
    pinned_bits: int = 8
    quantize_activations: bool = True
    # Bit widths the paged KV cache can STORE (repro.kvcache): 16 = fp,
    # 8 = int8 bytes, and the packed qtensor layouts 6 (3 bytes / 4
    # values), 4 and 3 (2 per byte). Unlike ``allowed_bits`` these must
    # be byte-realizable storage formats, not just fake-quant grids; the
    # conservative default sticks to {4, 8, 16} — pass e.g.
    # (3, 4, 6, 8, 16) to let the allocator use every packed width.
    kv_allowed_bits: Sequence[int] = (4, 8, 16)

    def is_pinned(self, name: str) -> bool:
        return any(s in name.lower() for s in self.pinned_substrings)

    def quantizable(self, name: str, ndim: int) -> bool:
        """Whether a weight block may be quantized below ``pinned_bits``.

        The ONE rule shared by serving PTQ (`launch/serve.py`,
        `repro.serve.quantized`) and MPQ search, so both always pin the
        same blocks: vectors (norm scales, biases, conv tails) and pinned
        substrings stay high-precision."""
        return ndim >= 2 and not self.is_pinned(name)

    def pinned_mask(self, names: Sequence[str]) -> np.ndarray:
        """Boolean (len(names),) mask of pinned blocks — the vectorized
        counterpart of ``is_pinned`` for array-backed scoring."""
        return np.array([self.is_pinned(n) for n in names], dtype=bool)

    def sanitize_indices(self, idx: np.ndarray, pinned: np.ndarray,
                         pin_level: int) -> np.ndarray:
        """Vectorized ``sanitize`` in level-index space: raise pinned
        columns to at least ``pin_level`` (the index of the smallest
        level >= ``pinned_bits`` in an ascending level set, where a
        column-wise max on indices equals a max on bits)."""
        idx = np.asarray(idx)
        out = idx.copy()
        out[..., pinned] = np.maximum(out[..., pinned], pin_level)
        return out

    def sanitize(self, cfg: BitConfig) -> BitConfig:
        wb = dict(cfg.weight_bits)
        ab = dict(cfg.act_bits)
        for k in list(wb):
            if self.is_pinned(k):
                wb[k] = max(wb[k], self.pinned_bits)
        for k in list(ab):
            if self.is_pinned(k):
                ab[k] = max(ab[k], self.pinned_bits)
        if not self.quantize_activations:
            ab = {k: 16 for k in ab}
        return BitConfig(wb, ab)

    def uniform(self, weight_blocks: Sequence[str], act_blocks: Sequence[str],
                bits: Optional[int] = None) -> BitConfig:
        b = bits if bits is not None else self.default_weight_bits
        return self.sanitize(BitConfig({k: b for k in weight_blocks},
                                       {k: b for k in act_blocks}))


def random_bit_config(
    weight_blocks: Sequence[str],
    act_blocks: Sequence[str],
    policy: QuantPolicy,
    rng: np.random.Generator,
) -> BitConfig:
    """Uniformly random bits per block — the paper's Table-2 sampling scheme."""
    bits = list(policy.allowed_bits)
    wb = {k: int(rng.choice(bits)) for k in weight_blocks}
    ab = {k: int(rng.choice(bits)) for k in act_blocks}
    return policy.sanitize(BitConfig(wb, ab))
