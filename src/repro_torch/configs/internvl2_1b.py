"""InternVL2-1B: InternViT vision encoder (stub) + InternLM2 backbone
[arXiv:2404.16821].  ``input_specs`` supplies projector-output patch
embeddings; the language backbone is fully implemented."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", arch_type="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    block_pattern=("attn",), frontend="vision", num_patch_tokens=256,
    rope_theta=1000000.0, tie_embeddings=True,
    source="InternViT + InternLM2 [arXiv:2404.16821]",
)
