"""whisper-tiny [audio] — encoder-decoder transformer; the conv/mel
frontend is stubbed as in ``repro``'s copy of this config: the encoder
consumes precomputed frame embeddings, 1500 frames. [arXiv:2212.04356]

``max_seq_len`` is enlarged to 32768 (whisper's decoder has 448 learned
positions) as in ``repro``; the PSL cut is the encoder/decoder boundary.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_seq=1500, cross_attention=True,
    learned_pos_embed=True, max_seq_len=32768,
    cut_layer=0,   # PSL cut = encoder/decoder boundary
    source="arXiv:2212.04356",
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced", family="audio",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    encoder_layers=2, encoder_seq=64, cross_attention=True,
    learned_pos_embed=True, max_seq_len=256, cut_layer=0,
    dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
    source="arXiv:2212.04356",
)
