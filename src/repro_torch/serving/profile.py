"""Measure real continuous-batching serve step times.

The fleet planner sizes replica fleets from one number per (model,
device class): the wall time of ONE batched decode step with the slots
full.  ``measure_serve_step_time`` produces that number by running a
:class:`~repro_torch.serving.engine.ContinuousBatchingEngine` on
``device``.  A warm-up request runs first and is not timed (cuBLAS
set-up, first kernel builds), and every slot stays busy so that the
step time is the batched regime the queueing model assumes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


def measure_serve_step_time(cfg: ModelConfig, *, slots: int = 4,
                            max_len: int = 32, prompt_len: int = 4,
                            new_tokens: int = 8, seed: int = 0,
                            reduce_model: bool = True,
                            device="cuda") -> float:
    """Wall seconds per batched decode step, slots saturated.

    Builds the (reduced, by default) model with weights from ``seed``,
    warms up with a throwaway request, then times a burst of
    ``2 * slots`` requests so every slot stays busy and refills at least
    once.  ``prompt_len`` / ``new_tokens`` only set how many steps get
    sampled; the per-step time is what matters.
    """
    from ..models.transformer import init_model
    from .engine import ContinuousBatchingEngine, Request

    dev = resolve_device(device)
    if reduce_model:
        cfg = cfg.reduced()
    prompt_len = max(1, min(prompt_len, max_len - new_tokens - 1))
    params = init_model(cfg, seed=seed, device=dev)
    eng = ContinuousBatchingEngine(cfg, params, slots=slots,
                                   max_len=max_len, device=dev)
    rng = np.random.RandomState(seed)

    def mk(rid):
        return Request(rid=rid,
                       prompt=rng.randint(0, cfg.vocab_size,
                                          prompt_len).tolist(),
                       max_new_tokens=new_tokens)

    eng.submit(mk(-1))          # warm-up, not timed
    eng.run()
    steps0 = eng.steps
    for i in range(2 * slots):
        eng.submit(mk(i))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n = eng.steps - steps0
    if n <= 0:
        raise RuntimeError("serve measurement ran zero engine steps")
    return dt / n
