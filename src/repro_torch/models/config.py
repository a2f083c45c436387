"""Model configuration and parameter-spec machinery (port of
:mod:`repro.models.config`).

A :class:`ModelConfig` fully describes one architecture, field for field
as in ``repro`` so one ``ModelSpec.overrides`` dict drives both packages;
builders in ``repro_torch.models`` turn it into a tree of
:class:`ParamSpec` (shape, logical axes, initializer) that ``init`` and
the cache allocators materialize. Dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Field defaults suit dense decoder LMs."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # tokens; None = full attention
    learned_pos_embed: bool = False        # whisper-style absolute positions

    # mixture of experts
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    moe_shared_expert: bool = False        # llama4-style always-on expert
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # grouped dispatch: tokens are dispatched within G independent groups
    # (aligned to the data shards) so expert *capacity* shards over the data
    # axes and expert compute scales with the full mesh, not just the expert
    # axis. 0 = single global dispatch (paper-baseline behaviour).
    moe_groups: int = 0

    # state-space (mamba)
    ssm_state: int = 0
    ssm_variant: str = ""                  # "mamba1" | "mamba2"
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64                 # mamba2 only
    ssm_chunk: int = 128                   # chunked-scan chunk length

    # hybrid (zamba2): shared attention block applied every `attn_period`
    # backbone layers (weights shared across applications).
    attn_period: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                   # precomputed frame embeddings
    cross_attention: bool = False

    # vlm: number of precomputed patch-embedding slots prepended to text
    num_patches: int = 0

    # PSL split point: number of decoder blocks on the client side.
    cut_layer: int = 2

    # numerics / schedule
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    remat: str = "dots"                    # none | dots | full
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512
    causal_block_skip: bool = True         # skip fully-masked kv blocks
    scan_layers: bool = True

    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.family in ("ssm",) and not self.ssm_variant:
            object.__setattr__(self, "ssm_variant", "mamba1")

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter leaf."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim
    init: str = "normal"              # normal | zeros | ones | embed | ssm_a
    dtype: Any = None                 # None -> model dtype
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")
