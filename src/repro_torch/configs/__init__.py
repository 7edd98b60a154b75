"""Assigned architecture configs (``get_config(<id>)``), the inputs of
the four workload shapes and synthetic batches.  Own copies of the JAX
package's configs; ``input_specs`` gives shapes and dtypes (no
allocation) for the dry run, and ``concrete_batch`` draws from the same
``np.random.RandomState`` stream, so it gives the same tokens, as torch
tensors on ``device``.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import InputShape, ModelConfig
from ..models.params import ShapeDtype

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


def shape_supported(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k only for sub-quadratic / windowed archs."""
    if shape.name == "long_500k":
        return cfg.long_context
    return True


def input_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16):
    """The model inputs of ``shape`` as ``ShapeDtype`` (train / prefill:
    the full sequence; decode: one token, the decode state apart)."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda *sh: ShapeDtype(sh, torch.int32)
    if shape.mode == "decode":
        return {"tokens": tok(b, 1)}
    if cfg.frontend == "audio":
        # EnCodec frame embeddings (stub frontend) + codec-token labels
        return {"embeds": ShapeDtype((b, s, cfg.d_model), dtype),
                "labels": tok(b, s)}
    if cfg.frontend == "vision":
        p = cfg.num_patch_tokens
        return {"embeds": ShapeDtype((b, p, cfg.d_model), dtype),
                "tokens": tok(b, s - p)}
    return {"tokens": tok(b, s)}


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
