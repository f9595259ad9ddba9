"""Model configurations (port of ``repro.configs``).

``ModelConfig`` is the same frozen dataclass as the reference's;
``param_dtype`` returns a torch dtype. ``ARCH_IDS`` registers the
reference's ten architectures (the dense, MoE, ssm, hybrid, audio and
vlm families) in its order. ``SHAPES`` maps the assigned input-shape ids
to (seq_len, global_batch, kind).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "swiglu"           # swiglu | gelu | relu2
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_compute_dtype: str = "float32"
    conv_width: int = 4
    ssm_groups: int = 1
    # hybrid (Zamba2-style shared attention block)
    attn_period: int = 0
    # frontends
    frontend: str = "none"
    img_tokens: int = 0
    num_codebooks: int = 1
    # numerics / structure
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attn_chunk: int = 1024        # online-softmax KV chunk size
    scan_layers: bool = True      # the port always runs the unrolled layout
    remat: bool = True
    skip_shapes: Tuple[str, ...] = ("long_500k",)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def param_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]


ARCH_IDS = [
    "mamba2_130m",
    "zamba2_7b",
    "olmoe_1b_7b",
    "deepseek_moe_16b",
    "musicgen_large",
    "minitron_4b",
    "llama3_8b",
    "phi3_mini_3_8b",
    "internlm2_1_8b",
    "phi3_vision_4_2b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    key = _ALIASES.get(name, name).replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells(multi_pod: bool = False):
    """All (arch, shape) dry-run cells, honouring per-arch skips."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if s.name in cfg.skip_shapes:
                continue
            out.append((a, s.name))
    return out
