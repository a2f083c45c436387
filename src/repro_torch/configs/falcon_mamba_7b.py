"""falcon-mamba-7b [ssm] — attention-free Mamba-1. [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_variant="mamba1", ssm_expand=2, ssm_conv=4,
    cut_layer=2,
    source="arXiv:2410.05355",
)

REDUCED = ModelConfig(
    name="falcon-mamba-7b-reduced", family="ssm",
    num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=8, ssm_variant="mamba1", ssm_conv=4, ssm_chunk=16,
    cut_layer=1, dtype="float32",
    source="arXiv:2410.05355",
)
