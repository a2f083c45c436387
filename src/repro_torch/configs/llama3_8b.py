"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0, cut_layer=2,
    source="arXiv:2407.21783",
)

REDUCED = ModelConfig(
    name="llama3-8b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=448, vocab_size=512, cut_layer=1, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32,
    source="arXiv:2407.21783",
)
