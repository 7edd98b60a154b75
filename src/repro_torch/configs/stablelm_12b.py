"""StableLM-2-12B-family dense decoder [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", arch_type="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    block_pattern=("attn",), rope_theta=10000.0,
    tie_embeddings=False,
    source="[hf:stabilityai/stablelm-2-1_6b]",
)
