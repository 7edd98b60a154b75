"""Model FLOPs of a training step, and the peaks they are held against.

Model FLOPs are the useful work of the tokens trained: for each weight
matrix a token uses, ``2 * in * out`` (the router and the top-k experts
of an MoE layer, no capacity padding); for each live (query, key) pair
under the causal mask and the window, ``4 * H * D`` (the scores and the
weighted values); the embedding lookup and the elementwise work count
nothing.  Forward and backward are three times the forward.  Work the
program repeats or wastes (recomputation, masked blocks, padded expert
slots) is not counted.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet: dense float32 outside the tensor cores,
# at the full power limit of 700 W
PEAK_FP32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}


def live_pairs(seq: int, window: int) -> int:
    """(query, key) pairs with key <= query and query - key < window
    (window 0: no window) in one sequence."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def matrix_flops_per_token(cfg: dict) -> int:
    """Forward FLOPs of the weight matrices one token uses."""
    d, h, kv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    attn = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    moe = cfg.get("moe")
    if moe:
        ffn = 2 * d * moe["num_experts"] \
            + moe["top_k"] * 3 * 2 * d * moe["d_ff_expert"]
    else:
        ffn = 3 * 2 * d * cfg["d_ff"]
    return cfg["num_layers"] * (attn + ffn) + 2 * d * cfg["vocab_size"]


def attention_flops_per_sequence(cfg: dict, seq: int) -> int:
    """Forward FLOPs of the scores and weighted values of one sequence."""
    h = cfg["num_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // h
    pattern = list(cfg["block_pattern"])
    total = 0
    for layer in range(cfg["num_layers"]):
        kind = pattern[layer % len(pattern)]
        window = cfg.get("window_size", 0) if kind == "swa" else 0
        total += 4 * h * hd * live_pairs(seq, window)
    return total


def step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``."""
    return 3 * batch * (seq * matrix_flops_per_token(cfg)
                        + attention_flops_per_sequence(cfg, seq))
