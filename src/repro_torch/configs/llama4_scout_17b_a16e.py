"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, d_ff_expert=8192,
    moe_shared_expert=True,
    rope_theta=500_000.0, cut_layer=2,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

REDUCED = ModelConfig(
    name="llama4-scout-17b-a16e-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    num_experts=4, experts_per_token=1, d_ff_expert=256,
    moe_shared_expert=True, cut_layer=1, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
