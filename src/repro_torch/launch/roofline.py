"""Roofline accounting (port of ``repro.launch.roofline``).

Hardware model: the NVIDIA H100 SXM's spec-sheet peaks, taken from
``obs.perf.cost`` so the port has one source of them (not measurements):

    PEAK_FLOPS = 989e12   bf16 dense tensor-core FLOP/s a card
    HBM_BW     = 3.35e12  B/s a card
    NVLINK_BW  = 450e9    B/s a card and direction (NVLink 4)

Terms per (arch x shape x cards), all in seconds a step:

    compute    = FLOPs_per_chip / PEAK_FLOPS
    memory     = bytes_per_chip / HBM_BW
    collective = link_traffic_per_chip / NVLINK_BW

``model_flops`` is the analytic useful-work count (6 * N_active * D for
training, 2 * N_active * D + attention for inference), the numerator of
a benchmark's MFU share; ``param_counts`` the analytic parameter counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.models.transformer import vocab_padded
from repro_torch.obs.perf.cost import HBM_BW, NVLINK_BW, PEAK_FLOPS


def _n_attn(cfg: ModelConfig) -> int:
    """Attention layers: every layer, or the hybrid's shared block once a
    group."""
    return (cfg.num_layers if cfg.family != "hybrid"
            else cfg.num_layers // cfg.attn_period)


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts: total, active-per-token, embedding, head."""
    d, L = cfg.d_model, cfg.num_layers
    v = vocab_padded(cfg)
    h, kv, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff

    attn = d * h * hd + 2 * d * kv * hd + h * hd * d if h else 0
    mlp_mult = 3 if cfg.act == "swiglu" else 2
    dense_mlp = mlp_mult * d * ff if ff else 0

    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        proj = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        mamba = d * proj + di * d + cfg.conv_width * (di + 2 * cfg.ssm_state)
    else:
        mamba = 0

    cb = cfg.num_codebooks if cfg.family == "audio" else 1
    emb = cb * v * d
    head = d * v * cb

    if cfg.family in ("dense", "audio", "vlm"):
        layer_active = attn + dense_mlp
        total = L * layer_active
    elif cfg.family == "moe":
        k = cfg.top_k
        experts = cfg.num_experts * 3 * d * ff
        shared = cfg.num_shared_experts * 3 * d * ff
        router = d * cfg.num_experts
        total = L * (attn + experts + shared + router)
        layer_active = attn + k * 3 * d * ff + shared + router
    elif cfg.family == "ssm":
        layer_active = mamba
        total = L * mamba
    elif cfg.family == "hybrid":
        total = L * mamba + (attn + dense_mlp)     # shared block stored once
    else:
        raise ValueError(cfg.family)

    active = (layer_active * L if cfg.family != "hybrid"
              else L * mamba + (attn + dense_mlp) * _n_attn(cfg))
    return {"total": total + emb + head, "active": active + head,
            "embed": emb, "head": head}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic useful FLOPs a step (MODEL_FLOPS)."""
    counts = param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.num_heads, cfg.head_dim
    recurrent = cfg.family in ("ssm", "hybrid")

    if shape.kind == "train":
        flops = 6.0 * counts["active"] * b * s
        if h:
            # causal: S^2/2 scores; QK^T + PV = 4 * S^2/2 * H * Dh forward,
            # x3 forward + backward
            flops += 12.0 * _n_attn(cfg) * b * s * s * 0.5 * h * hd
        if recurrent:
            flops += 3.0 * _ssd_fwd_flops(cfg, b, s)
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * counts["active"] * b * s
        if h:
            flops += 4.0 * _n_attn(cfg) * b * s * s * 0.5 * h * hd
        if recurrent:
            flops += _ssd_fwd_flops(cfg, b, s)
        return flops
    # decode: one token, cache depth s
    flops = 2.0 * counts["active"] * b
    if h:
        flops += 4.0 * _n_attn(cfg) * b * s * cfg.num_kv_heads * (
            h // max(cfg.num_kv_heads, 1)) * hd
    if recurrent:
        # state update + readout: ~6 * H * N * P a layer and token
        flops += 6.0 * cfg.num_layers * b * cfg.ssm_heads * cfg.ssm_state \
            * cfg.ssm_headdim
    return flops


def _ssd_fwd_flops(cfg: ModelConfig, b: int, s: int) -> float:
    """Chunked SSD forward flops (dominant terms)."""
    hh, p, n, q = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    per_tok = (2 * q * n            # C B^T within a chunk
               + 2 * q * hh * p     # M x
               + 2 * n * hh * p     # states build
               + 2 * n * hh * p)    # off-diagonal readout
    return float(cfg.num_layers) * b * s * per_tok


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    link_traffic_per_chip: float
    chips: int
    model_flops: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.link_traffic_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: the largest of the three terms
        (perfect overlap of compute, HBM and NVLink)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-optimistic step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "link_traffic_per_chip": self.link_traffic_per_chip,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
        }
