"""Model configuration for the composable decoder-transformer family.

One ``ModelConfig`` drives every assigned architecture: dense GQA
attention (full / sliding-window / local:global), RG-LRU hybrid blocks,
xLSTM (mLSTM/sLSTM) blocks, and MoE FFNs.  Layers are described by a
repeating ``block_pattern``; the transformer executes the pattern as a
loop over repeats (params stacked along a leading dim) plus an unrolled
remainder, so parameter trees keep the JAX package's stacked layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block-type vocabulary ("mixer" part of a block).
ATTN = "attn"      # full causal attention
SWA = "swa"        # sliding-window causal attention (cfg.window_size)
RGLRU = "rglru"    # RG-LRU recurrent block (Griffin/RecurrentGemma)
MLSTM = "mlstm"    # xLSTM matrix-memory block
SLSTM = "slstm"    # xLSTM scalar-memory block

MIXERS = (ATTN, SWA, RGLRU, MLSTM, SLSTM)

# Block types that can decode with O(<<seq) state (no full-seq KV cache)
RECURRENT = (RGLRU, MLSTM, SLSTM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                    # dense FFN hidden size (0 = no FFN, e.g. xLSTM)
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = (ATTN,)
    window_size: int = 0         # for SWA blocks
    moe: Optional[MoEConfig] = None
    frontend: Optional[str] = None   # None | "audio" | "vision"
    num_patch_tokens: int = 256      # VLM: patch-embedding prefix length
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    d_rnn: int = 0               # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4          # temporal conv width in recurrent blocks
    long_context: bool = False   # eligible for the long_500k decode shape
    source: str = ""             # citation for the config

    def __post_init__(self):
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        for b in self.block_pattern:
            if b not in MIXERS:
                raise ValueError(f"unknown block type {b!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def layer_types(self) -> Tuple[str, ...]:
        """Expand block_pattern over num_layers."""
        p = self.block_pattern
        reps = (self.num_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.num_layers]

    def layer_plan(self):
        """[(kind, pattern, n)] — 'scan' over full pattern repeats plus an
        unrolled remainder.  A pattern of length L repeated n times is
        executed as one loop over per-position stacked params."""
        p = self.block_pattern
        n_full = self.num_layers // len(p)
        rem = self.num_layers % len(p)
        plan = []
        if n_full > 0:
            plan.append(("scan", p, n_full))
        if rem:
            plan.append(("unroll", p[:rem], 1))
        return plan

    def supports_long_context(self) -> bool:
        """True if decode state is sub-linear in history for every layer
        (recurrent) or bounded-window — i.e. no layer needs an unbounded
        full-attention KV cache *except* ones we explicitly shard."""
        return all(t in RECURRENT or t == SWA for t in self.block_pattern)

    def has_global_attention(self) -> bool:
        return any(t == ATTN for t in self.block_pattern)

    def reduced(self, *, num_layers: int = 2, max_d_model: int = 256,
                max_experts: int = 4, max_vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        d = min(self.d_model, max_d_model)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 2 * d))
        pat = self.block_pattern
        if num_layers < len(pat):
            num_layers = len(pat)  # keep at least one full pattern
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=num_layers,
            d_model=d, num_heads=heads, num_kv_heads=kv,
            d_ff=min(self.d_ff, 2 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, max_vocab),
            head_dim=d // heads, moe=moe,
            window_size=min(self.window_size, 32) if self.window_size else 0,
            d_rnn=min(self.resolved_d_rnn, d) if self.d_rnn else 0,
            num_patch_tokens=min(self.num_patch_tokens, 8),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
