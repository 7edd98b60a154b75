"""Continuous-batching serving engine.

Token-granularity continuous batching over a fixed pool of batch slots:
every engine step runs ONE batched ``decode_step``; a slot that still has
unconsumed prompt tokens is fed the next prompt token (inline chunk-1
prefill), otherwise its last sampled token.  Finished slots are refilled
from the request queue immediately, each slot at its own cache position
(the per-row ``pos`` decode path).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import tree_leaves_with_paths, tree_map
from ..models.transformer import (decode_step, init_decode_state,
                                  state_batch_axes)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    done_s: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    prompt_left: int = 0

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatchingEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, dtype=torch.float32,
                 eos_id: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = slots, max_len
        self.eos_id = eos_id
        self.state = init_decode_state(cfg, slots, max_len, dtype=dtype,
                                       per_row_pos=True, device=self.device)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.steps = 0
        self._t0: Optional[float] = None   # engine epoch: first run() call
        # the batch axis of every state leaf is known from the layer plan
        self._batch_axis = state_batch_axes(cfg)

    # ------------------------------------------------------------ public
    def submit(self, req: Request):
        """Queue ``req`` for admission, in ``arrival_s`` order with ties
        broken by submission order.  An infeasible request (prompt +
        generation budget beyond the cache) is rejected here."""
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid} exceeds max_len "
                             f"({len(req.prompt)} + {req.max_new_tokens} "
                             f"> {self.max_len})")
        bisect.insort_right(self.queue, req, key=lambda r: r.arrival_s)

    def run(self, max_steps: int = 10000) -> List[Request]:
        """Run until queue + slots drain.  Returns finished requests.
        The engine clock starts at the FIRST ``run()`` call and persists
        across calls."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        while (self.queue or any(not s.free for s in self.slots)) \
                and self.steps < max_steps:
            self._admit()
            self._engine_step(self._t0)
        return self.finished

    def throughput(self) -> Dict[str, float]:
        toks = sum(len(r.output) for r in self.finished)
        lat = [r.done_s - r.arrival_s for r in self.finished
               if r.done_s is not None]
        ttft = [r.ttft_s for r in self.finished if r.ttft_s is not None]
        return {"requests": len(self.finished), "tokens": toks,
                "steps": self.steps,
                "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
                "p50_latency_s": float(np.percentile(lat, 50)) if lat else 0.0,
                "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
                "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0}

    # ----------------------------------------------------------- private
    def _admit(self):
        for b, slot in enumerate(self.slots):
            if slot.free and self.queue:
                req = self.queue.pop(0)
                slot.req = req
                slot.prompt_left = len(req.prompt)
                self.state["pos"][b] = 0     # reset this slot's position
                self._reset_slot_state(b)

    def _reset_slot_state(self, b: int):
        """Clear slot b's recurrent state (KV entries are masked by pos,
        so k and v stay; attention-only models carry nothing else)."""
        leaves = tree_leaves_with_paths(self.state["layers"])
        axes = tree_leaves_with_paths(self._batch_axis["layers"])
        for (path, leaf), (_, ax) in zip(leaves, axes):
            if path[-1] not in ("k", "v"):
                leaf.select(ax, b).fill_(-1e30 if path[-1] == "m" else 0)

    @torch.no_grad()
    def _step(self, tokens, active):
        logits, new_state = decode_step(self.params, self.cfg, tokens,
                                        self.state)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

        def splice(new, old, ax):
            # frozen slots keep their previous state; a leaf the decode
            # step updated in place (the KV caches) is already spliced:
            # a frozen slot's write at its own pos is masked until that
            # slot is reused, and then overwritten before it is read
            if new is old or new.ndim == 0:
                return new
            shape = [1] * new.ndim
            shape[ax] = -1
            return torch.where(active.reshape(shape), new, old)

        return nxt, tree_map(splice, new_state, self.state, self._batch_axis)

    def _engine_step(self, t0: float):
        tokens = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros((self.n_slots,), bool)
        for b, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.req
            active[b] = True
            if slot.prompt_left > 0:
                idx = len(req.prompt) - slot.prompt_left
                tokens[b, 0] = req.prompt[idx]
            else:
                tokens[b, 0] = req.output[-1]
        nxt, self.state = self._step(
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(active, device=self.device))
        self.steps += 1
        nxt = nxt.cpu().numpy()
        now = time.perf_counter() - t0
        for b, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.req
            if slot.prompt_left > 0:
                slot.prompt_left -= 1
                if slot.prompt_left == 0:
                    # this step consumed the last prompt token => its
                    # output is the first generated token
                    req.output.append(int(nxt[b]))
                    req.ttft_s = now
            else:
                req.output.append(int(nxt[b]))
            done = len(req.output) >= req.max_new_tokens or (
                self.eos_id is not None and req.output
                and req.output[-1] == self.eos_id)
            if done:
                req.done_s = now
                self.finished.append(req)
                self.slots[b] = _Slot()

