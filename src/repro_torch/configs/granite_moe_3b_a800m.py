"""granite-moe-3b-a800m [moe] — 40 experts top-8, narrow experts.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, experts_per_token=8, d_ff_expert=512,
    cut_layer=2,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced", family="moe",
    num_layers=2, d_model=120, num_heads=6, num_kv_heads=2,
    head_dim=20, d_ff=128, vocab_size=512,
    num_experts=4, experts_per_token=2, d_ff_expert=128,
    cut_layer=1, dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
