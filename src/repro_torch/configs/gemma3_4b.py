"""Gemma-3-4B: 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", arch_type="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    d_ff=10240, vocab_size=262144, head_dim=256,
    block_pattern=("swa",) * 5 + ("attn",), window_size=1024,
    rope_theta=1000000.0, tie_embeddings=True, long_context=True,
    source="5:1 local:global, 128k [hf:google/gemma-3-1b-pt]",
)
