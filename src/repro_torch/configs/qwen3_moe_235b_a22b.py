"""Qwen3-MoE-235B-A22B: 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=0, vocab_size=151936, head_dim=128,
    block_pattern=("attn",), rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    tie_embeddings=False,
    source="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]",
)
