"""Assigned architecture configs (``get_config(<id>)``) and synthetic
batches.  Own copies of the JAX package's configs; ``concrete_batch``
draws from the same ``np.random.RandomState`` stream, so it gives the
same tokens, as torch tensors on ``device``.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig

ARCH_IDS = [
    "stablelm-12b",
    "internlm2-20b",
    "xlstm-125m",
    "recurrentgemma-2b",
    "musicgen-medium",
    "qwen3-moe-235b-a22b",
    "gemma3-4b",
    "internvl2-1b",
    "h2o-danube-3-4b",
    "olmoe-1b-7b",
]


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def concrete_batch(cfg: ModelConfig, batch: int, seq: int, key=None,
                   dtype=torch.float32, device="cuda"):
    """Concrete synthetic batch: the JAX package's numpy stream, as
    tensors (tokens int32) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0 if key is None else key)
    tok = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    emb = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    out = {}
    if cfg.frontend == "audio":
        out["embeds"] = emb(rng.randn(batch, seq, cfg.d_model))
        out["labels"] = tok(rng.randint(0, cfg.vocab_size, (batch, seq)))
    elif cfg.frontend == "vision":
        p = min(cfg.num_patch_tokens, seq - 1)
        out["embeds"] = emb(rng.randn(batch, p, cfg.d_model))
        out["tokens"] = tok(rng.randint(0, cfg.vocab_size, (batch, seq - p)))
    else:
        out["tokens"] = tok(rng.randint(0, cfg.vocab_size, (batch, seq)))
    return out
