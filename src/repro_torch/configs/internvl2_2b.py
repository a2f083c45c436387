"""internvl2-2b [vlm] — InternLM2 decoder consuming InternViT patch
embeddings (vision frontend stubbed per the assignment carve-out: 256
precomputed patch-embedding slots). [arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    num_patches=256, rope_theta=1_000_000.0, cut_layer=2,
    source="arXiv:2404.16821",
)

REDUCED = ModelConfig(
    name="internvl2-2b-reduced", family="vlm",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, num_patches=16, cut_layer=1,
    dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
    source="arXiv:2404.16821",
)
