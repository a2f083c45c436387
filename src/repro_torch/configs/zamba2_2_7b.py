"""zamba2-2.7b [hybrid] — Mamba-2 backbone + shared attention block applied
every 6 backbone layers (one weight set, reused). [arXiv:2411.15242]

As in ``repro``'s copy of this config: the real Zamba2 concatenates the
original embedding with the hidden state at each shared-attention
application and includes an MLP in the shared block; the shared attention
is applied on the hidden state alone (d_ff, the shared block's MLP width,
is unused).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_variant="mamba2", ssm_expand=2, ssm_conv=4,
    ssm_head_dim=64, attn_period=6,
    cut_layer=2,
    source="arXiv:2411.15242",
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced", family="hybrid",
    num_layers=5, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512,
    ssm_state=8, ssm_variant="mamba2", ssm_head_dim=32, ssm_conv=4,
    ssm_chunk=16, attn_period=2, cut_layer=1, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32,
    source="arXiv:2411.15242",
)
