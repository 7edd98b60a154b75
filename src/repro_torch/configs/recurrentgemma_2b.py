"""RecurrentGemma-2B: RG-LRU + local attention, 1:2 ratio [arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "swa"), window_size=2048,
    d_rnn=2560, tie_embeddings=True, long_context=True,
    source="RG-LRU + local attn, 1:2 [arXiv:2402.19427]",
)
