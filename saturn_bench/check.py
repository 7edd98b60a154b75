"""The numbers that decide ``correct``: the program's first training
steps against the reference's on the same weights and batches.

- ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the
  checked steps' cross-entropies.
- ``grad_norm_gap``: over the leaves, the largest gap between the
  program's and the reference's norm of the first gradient as the
  optimizer takes it (clipped), ``| |g_prog| - |g_ref| |``, against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.
- ``change_norm_gap``: the same of each leaf's change after the checked
  steps, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (a leaf with a gradient that is
  nought to rounding moves under Adam by round-off alone).
- ``grad_norm_gap.median``, ``change_norm_gap.median``: the median leaf's
  gap instead of the worst leaf's, steady from seed to seed where rare
  discrete events (an MoE route that flips on a near tie between the
  two sides) move one leaf.

A cell compares the numbers its workload file gives a limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

NAMES = ("loss_gap", "grad_norm_gap", "change_norm_gap",
         "grad_norm_gap.median", "change_norm_gap.median")
MOVED = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Iterable[str]) -> list:
    """Each leaf's ``| |prog| - |ref| |`` against the larger of its
    reference norm and the median leaf's."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med)
            if k in prog and math.isfinite(prog[k]) else math.inf
            for k in keys]


def left_out(ref: dict) -> list:
    """The leaves whose first reference gradient is under ``MOVED`` of
    the median leaf's."""
    med = statistics.median(ref["grad_norms"].values())
    return sorted(k for k, g in ref["grad_norms"].items() if g < MOVED * med)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: ``losses`` (one a checked step), ``grad_norms`` and
    ``change_norms`` ({leaf path: norm})."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                ref["losses"])]
    if len(gaps) != len(ref["losses"]) or not all(map(math.isfinite, gaps)):
        gaps = [math.inf]
    grads = ref["grad_norms"]
    moved = [k for k in grads if k not in left_out(ref)]
    g = leaf_gaps(prog["grad_norms"], grads, grads)
    ch = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": max(gaps),
            "grad_norm_gap": max(g), "change_norm_gap": max(ch),
            "grad_norm_gap.median": statistics.median(g),
            "change_norm_gap.median": statistics.median(ch)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number that ``limits`` names is within its limit."""
    return all(math.isfinite(values[n]) and values[n] <= lim
               for n, lim in limits.items())
