"""MusicGen-medium decoder over EnCodec tokens [arXiv:2306.05284].

Frontend (EnCodec + pattern interleaver) is a stub per the assignment
carve-out: ``input_specs`` supplies precomputed frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", arch_type="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    block_pattern=("attn",), frontend="audio",
    tie_embeddings=False,
    source="decoder-only over EnCodec tokens [arXiv:2306.05284]",
)
