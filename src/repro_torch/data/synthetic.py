"""Deterministic synthetic data pipeline.

Generates seeded token streams (a stationary bigram process so the loss
is learnable, not pure noise) and frontend embeddings for audio/VLM
archs.  The numpy draws are the JAX package's, in the same order, so
both packages see bit-identical tokens and embeddings for a seed, and
``skip=`` lands on the same batch.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


class SyntheticLM:
    """Seeded bigram-ish token source: next token depends on previous via
    a fixed random permutation + noise, giving a learnable structure."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, noise: float = 0.3):
        self.cfg = cfg
        self.seed = seed
        self.noise = noise
        rng = np.random.RandomState(seed)
        v = cfg.vocab_size
        self._perm = rng.permutation(v)

    def _raw_batch(self, rng: np.random.RandomState, batch: int,
                   seq: int) -> dict:
        """One batch as host numpy arrays.  ALL rng draws happen here,
        in a fixed order, so fast-forwarding the stream (``skip``) lands
        on exactly the batch an uninterrupted consumer would see."""
        cfg = self.cfg
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.randint(0, cfg.vocab_size, batch)
        for t in range(1, seq + 1):
            nxt = self._perm[toks[:, t - 1]]
            flip = rng.rand(batch) < self.noise
            nxt = np.where(flip, rng.randint(0, cfg.vocab_size, batch), nxt)
            toks[:, t] = nxt
        out = {}
        if cfg.frontend == "audio":
            out["embeds"] = rng.randn(batch, seq, cfg.d_model) * 0.02
            out["labels"] = toks[:, 1:]
        elif cfg.frontend == "vision":
            p = min(cfg.num_patch_tokens, max(seq - 2, 1))
            out["embeds"] = rng.randn(batch, p, cfg.d_model) * 0.02
            out["tokens"] = toks[:, : seq - p]
        else:
            out["tokens"] = toks[:, :seq]
        return out

    def batches(self, batch: int, seq: int, *, dtype=torch.float32,
                num_batches: Optional[int] = None, skip: int = 0,
                device="cuda") -> Iterator[dict]:
        """Yield batches on ``device``: int32 tokens and labels, float
        embeddings in ``dtype``.  ``skip`` fast-forwards the stream past
        that many batches first (checkpoint resume: a run continued from
        step k must see batch k next, not batch 0 again)."""
        dev = resolve_device(device)
        return self._stream(batch, seq, dtype, num_batches, skip, dev)

    def _stream(self, batch, seq, dtype, num_batches, skip, dev):
        rng = np.random.RandomState(self.seed + 1)
        for _ in range(max(0, int(skip))):
            self._raw_batch(rng, batch, seq)
        i = 0
        while num_batches is None or i < num_batches:
            raw = self._raw_batch(rng, batch, seq)
            yield {k: torch.as_tensor(
                       v, dtype=dtype if v.dtype.kind == "f" else torch.int32,
                       device=dev)
                   for k, v in raw.items()}
            i += 1
