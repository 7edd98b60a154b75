"""H2O-Danube3-4B: llama/mistral-mix dense decoder with sliding-window
attention [arXiv:2401.16818]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", arch_type="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    block_pattern=("swa",), window_size=4096,
    tie_embeddings=False, long_context=True,
    source="llama+mistral mix, SWA [arXiv:2401.16818]",
)
