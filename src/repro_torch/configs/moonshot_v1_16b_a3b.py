"""moonshot-v1-16b-a3b — Moonlight-16B-A3B: MoE 64 experts top-6 (+shared
expert), 16 q heads == 16 kv heads. The assignment tags it [dense] but the
spec line is MoE 64e top-6; we implement the MoE (active ~3B) variant.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=163840,
    num_experts=64, experts_per_token=6, d_ff_expert=1408,
    moe_shared_expert=True,
    rope_theta=50_000.0, cut_layer=2,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

REDUCED = ModelConfig(
    name="moonshot-v1-16b-a3b-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    num_experts=4, experts_per_token=2, d_ff_expert=128,
    moe_shared_expert=True, cut_layer=1, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
