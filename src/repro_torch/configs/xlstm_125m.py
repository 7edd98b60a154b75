"""xLSTM-125M: alternating mLSTM/sLSTM blocks [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", arch_type="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True, long_context=True,
    source="sLSTM + mLSTM blocks [arXiv:2405.04517]",
)
