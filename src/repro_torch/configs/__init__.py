"""Model configurations (port of ``repro.configs``).

``ModelConfig`` is the same frozen dataclass as the reference's;
``param_dtype`` returns a torch dtype. Only the architectures the port
serves so far are registered here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

import torch


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


ARCH_IDS = ["internlm2_1_8b", "olmoe_1b_7b", "deepseek_moe_16b"]


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def smoke_config(name: str) -> ModelConfig:
    key = name.replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{key}").SMOKE
