"""Cells at a size the CPU tests can hold, with the real cells' traffic
and limits: one MoE and one dense configuration of the families the
benchmark runs."""
from __future__ import annotations

import copy

from . import cells

MOE = {"name": "tiny-moe", "arch_type": "moe", "num_layers": 2,
       "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
       "d_ff": 0, "vocab_size": 256, "block_pattern": ["attn"],
       "window_size": 0,
       "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
               "capacity_factor": 1.25, "router_aux_weight": 0.01},
       "rope_theta": 10000.0, "norm_eps": 1e-05, "tie_embeddings": False,
       "initializer_range": 0.02}
DENSE = {"name": "tiny-dense", "arch_type": "dense", "num_layers": 3,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 96, "vocab_size": 256, "block_pattern": ["swa"],
         "window_size": 24, "rope_theta": 10000.0, "norm_eps": 1e-05,
         "tie_embeddings": False, "initializer_range": 0.02}
CONFIGS = {"moe": MOE, "dense": DENSE}
# fp32 on the CPU, where a tiny leaf averages few roundings: sound runs
# read at most 8e-8 (loss), 8e-7 (gradient norms), 3.4e-6 (change
# norms); the faults read 4e-4 and more
LIMITS = {"loss_gap": 1e-06, "grad_norm_gap": 1e-05, "change_norm_gap": 2e-05}


def cell(kind: str, workload: str, seq: int = 64, batch: int = 2,
         technique: str = "ddp") -> cells.Cell:
    """The real cell ``workload`` with the tiny configuration ``kind``,
    the given job sizes and the CPU's limits."""
    real = cells.load_cell(workload)
    traffic = dict(copy.deepcopy(real.traffic), seq_len=seq, batch=batch,
                   technique=technique, limits=dict(LIMITS))
    return cells.Cell(workload, copy.deepcopy(CONFIGS[kind]), traffic,
                      1, real.end_to_end, real.per_layer)
