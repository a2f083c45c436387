"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155,
    cut_layer=2, rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

REDUCED = ModelConfig(
    name="granite-3-2b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512, cut_layer=1, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
