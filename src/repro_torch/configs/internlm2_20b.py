"""InternLM2-20B dense decoder with GQA [arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", arch_type="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    block_pattern=("attn",), rope_theta=1000000.0,
    tie_embeddings=False,
    source="GQA [arXiv:2403.17297]",
)
