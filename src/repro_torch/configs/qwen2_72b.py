"""qwen2-72b [dense] — GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    cut_layer=2,
    source="arXiv:2407.10671",
)

REDUCED = ModelConfig(
    name="qwen2-72b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=448, vocab_size=512, qkv_bias=True, cut_layer=1,
    dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
    source="arXiv:2407.10671",
)
