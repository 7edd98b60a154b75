"""Serving step function (the training steps are not ported yet)."""
from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.transformer import decode_step


def make_serve_step(cfg: ModelConfig, *, opts: Optional[dict] = None):
    """Returns serve_step(params, tokens (B,1), state) ->
    (next_tokens (B,1) greedy, logits, new_state)."""

    @torch.no_grad()
    def serve_step(params, tokens, state):
        logits, new_state = decode_step(params, cfg, tokens, state, opts=opts)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, new_state

    return serve_step
