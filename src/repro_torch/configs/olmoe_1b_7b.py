"""OLMoE-1B-7B: 64 experts, top-8 [arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", arch_type="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=50304, head_dim=128,
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    tie_embeddings=False,
    source="64 experts top-8 [arXiv:2409.02060]",
)
