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
    def ssm_num_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count of the registered LM configs, as
        ``repro``'s (every expert; the encoder and the decoder's
        cross-attention blocks for the audio family)."""
        d, v, hd = self.d_model, self.vocab_size, self.head_dim
        n_attn = (self.num_heads * hd + 2 * self.num_kv_heads * hd) * d \
            + self.num_heads * hd * d
        n_mlp_dense = 3 * d * self.d_ff if self.d_ff else 0
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        per_layer = 0
        if self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            if self.ssm_variant == "mamba1":
                per_layer = (2 * d * di + di * self.ssm_conv
                             + di * (self.dt_rank + 2 * n)
                             + self.dt_rank * di + di * n + di + di * d)
            else:
                nh = self.ssm_num_heads
                per_layer = (d * (2 * di + 2 * n + nh)
                             + (di + 2 * n) * self.ssm_conv
                             + 3 * nh + di + di * d)
            total += self.num_layers * (per_layer + d)
        elif self.family == "hybrid":
            di, n, nh = self.d_inner, self.ssm_state, self.ssm_num_heads
            per_layer = (d * (2 * di + 2 * n + nh)
                         + (di + 2 * n) * self.ssm_conv
                         + 3 * nh + di + di * d + d)
            total += self.num_layers * per_layer
            total += n_attn + 2 * d  # one shared attention block
        else:
            if self.is_moe:
                ffe = self.d_ff_expert or self.d_ff
                n_router = d * self.num_experts
                n_experts = self.num_experts * 3 * d * ffe
                n_shared = 3 * d * self.d_ff if self.moe_shared_expert else 0
                moe = n_router + n_experts + n_shared
                per_layer = n_attn + moe + 2 * d
            else:
                per_layer = n_attn + n_mlp_dense + 2 * d
            total += self.num_layers * per_layer
        if self.encoder_layers:
            enc_per = n_attn + n_mlp_dense + 2 * d
            total += self.encoder_layers * enc_per
            # decoder cross-attention blocks
            total += self.num_layers * (n_attn + d)
        return int(total)


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
