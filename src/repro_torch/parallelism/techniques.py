"""The five concrete techniques registered in Saturn's Parallelism
Library (paper §3 registers FSDP, DDP, GPipe, offloading; we add TP and
implement offloading as full-remat).  A copy of the JAX package's
module, so that ``search_space`` and ``plan`` agree with it; the port's
``BuiltJob`` executes every plan: at one device without a process
group, at n devices as one rank of an n-rank group.
"""
from __future__ import annotations

from .base import Plan, Technique


class DDP(Technique):
    """Replicated params, batch sharded (torch-DDP analogue via pjit)."""

    name = "ddp"

    def search_space(self, cfg, n):
        return n >= 1  # memory feasibility is checked by the Trial Runner

    def plan(self, cfg, n):
        return Plan(self.name, n, (("data", n),),
                    {"batch": "data"}, param_policy="replicate")

    def memory_fraction(self, cfg, n):
        return 1.0

    def step_overhead(self):
        return 1.05  # grad all-reduce


class FSDP(Technique):
    """ZeRO-3: params + opt state sharded over data axis, batch sharded."""

    name = "fsdp"

    def search_space(self, cfg, n):
        return n >= 2

    def plan(self, cfg, n):
        return Plan(self.name, n, (("data", n),),
                    {"batch": "data"}, param_policy="fsdp")

    def memory_fraction(self, cfg, n):
        return 1.0 / n

    def step_overhead(self):
        return 1.15  # per-layer all-gather + reduce-scatter


class TP(Technique):
    """Megatron-style tensor parallelism: heads / FFN / experts sharded
    over the model axis; batch replicated.  For MoE archs this is expert
    parallelism (experts over the model axis, all-to-all dispatch)."""

    name = "tp"

    def search_space(self, cfg, n):
        if n < 2:
            return False
        ok_heads = cfg.num_heads % n == 0
        ok_ffn = (cfg.d_ff % n == 0) if cfg.d_ff else True
        ok_exp = (cfg.moe.num_experts % n == 0) if cfg.is_moe else True
        return ok_heads and ok_ffn and ok_exp

    def plan(self, cfg, n):
        kv_ok = cfg.num_kv_heads % n == 0
        rules = {
            "batch": None,
            "heads": "model",
            "kv_heads": "model" if kv_ok else None,
            "ffn": "model",
            "experts": "model",
            "vocab": "model",
            "rnn": "model",
        }
        return Plan(self.name, n, (("model", n),), rules,
                    param_policy="rules")

    def memory_fraction(self, cfg, n):
        return 1.0 / n + 0.05

    def step_overhead(self):
        return 1.25  # per-layer all-reduce of activations


class GPipe(Technique):
    """Pipeline parallelism: contiguous repeats of the block pattern per
    stage, microbatched with a shard_map + ppermute schedule."""

    name = "gpipe"

    def __init__(self, microbatches: int = 4):
        self.microbatches = microbatches

    def search_space(self, cfg, n):
        if n < 2:
            return False
        plan = cfg.layer_plan()
        # need a single scanned group whose repeat count divides by stages
        if len(plan) != 1 or plan[0][0] != "scan":
            return False
        return plan[0][2] % n == 0

    def plan(self, cfg, n):
        return Plan(self.name, n, (("stage", n),), {"batch": None},
                    param_policy="stage", stages=n,
                    microbatches=self.microbatches)

    def memory_fraction(self, cfg, n):
        return 1.0 / n + 0.1

    def step_overhead(self):
        # bubble fraction (S-1)/(M+S-1) baked in empirically; rough prior
        return 1.3


class RematOffload(Technique):
    """Activation rematerialization — the TPU-native stand-in for
    FairScale CPU offloading (same system role: fit on fewer chips at
    the cost of step time; see DESIGN.md §5)."""

    name = "remat-offload"

    def search_space(self, cfg, n):
        return n >= 1

    def plan(self, cfg, n):
        return Plan(self.name, n, (("data", n),),
                    {"batch": "data"}, param_policy="fsdp", remat=True)

    def memory_fraction(self, cfg, n):
        return 0.6 / n  # sharded params + no stored activations

    def step_overhead(self):
        return 1.33  # forward recompute in backward


DEFAULT_TECHNIQUES = [DDP(), FSDP(), TP(), GPipe(), RematOffload()]
