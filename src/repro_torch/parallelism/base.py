"""Parallelism technique interface — the paper's two-function API.

Saturn's Parallelism Library registers techniques implementing (Fig. 1B):

  ``search_space(cfg, n_devices) -> bool``  — is this technique valid for
      this model at this device count?
  ``plan(cfg, n_devices) -> Plan``          — how to execute it: mesh
      axes, logical->mesh rules, param shardings, step-fn wrapping.

``Plan`` is consumed by ``parallelism.build.BuiltJob`` (real execution)
and by the launch path.  This module is framework-neutral: a copy of the
JAX package's, so that both packages plan alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Plan:
    technique: str
    n_devices: int
    # mesh axis names and sizes, e.g. (("data", 8),) or (("stage", 4),)
    mesh_axes: Tuple[Tuple[str, int], ...]
    # logical activation axis -> mesh axis (for context.axis_rules)
    rules: Dict[str, Optional[str]]
    # per-param sharding policy: "replicate" | "fsdp" | "rules" | "stage"
    param_policy: str = "replicate"
    remat: bool = False
    microbatches: int = 1
    stages: int = 1

    @property
    def mesh_shape(self):
        return tuple(n for _, n in self.mesh_axes)

    @property
    def mesh_axis_names(self):
        return tuple(a for a, _ in self.mesh_axes)


class Technique:
    """Base class; subclasses are registered in the Parallelism Library."""

    name: str = "base"

    def search_space(self, cfg: ModelConfig, n_devices: int) -> bool:
        raise NotImplementedError

    def plan(self, cfg: ModelConfig, n_devices: int) -> Plan:
        raise NotImplementedError

    # -- analytic hints used by the Trial Runner's cost model ------------
    def memory_fraction(self, cfg: ModelConfig, n_devices: int) -> float:
        """Approx fraction of total model+opt state held per device."""
        return 1.0

    def step_overhead(self) -> float:
        """Multiplicative runtime overhead vs ideal scaling (collectives,
        bubbles, recompute).  Refined empirically by the Trial Runner."""
        return 1.0


def largest_divisible_axis(shape, n: int) -> Optional[int]:
    """Index of the largest dim divisible by n (for FSDP-style sharding)."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best, best_size = i, s
    return best
