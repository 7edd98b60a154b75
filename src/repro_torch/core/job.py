"""Job and cluster specifications for multi-large-model training."""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig


@dataclasses.dataclass(frozen=True)
class Job:
    """One model-selection trial: a model + hyperparameters + work amount.

    The paper's workload (Table 1) is a grid over {model} x {lr} x
    {batch size} for a fixed number of epochs; each grid point is a Job.

    ``weight``, ``deadline_s`` and ``tenant`` only matter under the
    alternative solver objectives (weighted completion time, tardiness,
    per-tenant fair share); the defaults make every job equivalent, so
    the makespan objective ignores them.
    """
    name: str
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    total_steps: int
    lr: float = 1e-4
    seed: int = 0
    arrival_s: float = 0.0          # online workloads: submission time
    weight: float = 1.0             # objective weight (completion/tardiness)
    deadline_s: Optional[float] = None   # due time for the tardiness objective
    tenant: str = "default"         # owner for the fair-share objective

    @property
    def opt_cfg(self) -> AdamWConfig:
        return AdamWConfig(lr=self.lr, warmup_steps=min(100, self.total_steps // 10 + 1),
                           total_steps=self.total_steps)


# Profile-key technique under which serving (continuous-batching decode)
# throughput is recorded: a serve profile keyed (name, SERVE_TECH, class,
# gpus_per_replica) carries the per-token engine step time of ONE replica,
# exactly like a training profile carries a training step time.
SERVE_TECH = "serve"


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """One serving fleet: a model behind a latency SLO fed by a request
    trace.  The inference-side sibling of :class:`Job` — it flows through
    the same profile → solve → execute → observe loop, but instead of a
    step budget it carries *traffic*: ``trace`` is a tuple of request
    arrival times (seconds, runtime clock; see :mod:`repro_torch.data.traffic`
    for the seeded diurnal/bursty generators).

    A fleet is served by N replicas of ``gpus_per_replica`` GPUs, each
    running a :class:`~repro_torch.serving.engine.ContinuousBatchingEngine`
    with ``slots`` concurrent sequences; a request occupies a slot for
    ``prompt_len + max_new_tokens`` engine steps.  The SLO is on p99
    request latency (arrival → last token) per traffic window.
    """
    name: str
    cfg: ModelConfig
    slo_p99_s: float                 # p99 latency SLO per window (seconds)
    trace: tuple = ()                # request arrival times (seconds)
    prompt_len: int = 32             # prompt tokens per request
    max_new_tokens: int = 96         # decode tokens per request
    slots: int = 8                   # concurrent sequences per replica
    gpus_per_replica: int = 1
    max_replicas: int = 64           # fleet-size cap for the planner
    arrival_s: float = 0.0           # when the fleet comes online
    weight: float = 1.0
    tenant: str = "default"

    def __post_init__(self):
        object.__setattr__(self, "trace", tuple(self.trace))

    @property
    def tokens_per_request(self) -> int:
        return self.prompt_len + self.max_new_tokens


DEFAULT_CLASS = "default"


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One homogeneous slice of a (possibly mixed) cluster: a device
    generation / memory size, e.g. A100-40GB vs V100-16GB.

    ``speed_hint`` is the relative throughput vs the cluster's reference
    hardware (1.0 = reference): the profiler scales its roofline
    constants by it, so per-class trials land at realistic speeds even
    in the analytic/napkin backends.
    """
    name: str
    nodes: int = 1
    gpus_per_node: int = 8
    hbm_per_gpu: float = 40e9       # bytes
    speed_hint: float = 1.0         # relative throughput vs reference

    @property
    def total_gpus(self) -> int:
        return self.nodes * self.gpus_per_node


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The GPU cluster: the paper evaluates 1 and 2 p4d.24xlarge nodes
    (8 GPUs each); the TPU adaptation treats a "node" as an ICI slice.

    Heterogeneous fleets pass ``device_classes`` — a tuple of
    :class:`DeviceClass` records (mixed generations / memory sizes).
    The legacy single-class constructor (``nodes`` x ``gpus_per_node``)
    is kept as a shim: it synthesizes one "default" class, and every
    class-aware code path reduces to the historical behavior.  When
    ``device_classes`` is given it is authoritative: the legacy fields
    are ignored and ``total_gpus`` sums over the classes.
    """
    nodes: int = 1
    gpus_per_node: int = 8
    hbm_per_gpu: float = 40e9       # bytes (A100-40GB on p4d.24xlarge)
    restart_cost_s: float = 30.0    # checkpoint + relaunch penalty
    placement: str = "flat"         # runtime placement backend: flat | node
    device_classes: tuple = ()      # Tuple[DeviceClass, ...]; () = legacy

    def __post_init__(self):
        if not self.device_classes:
            object.__setattr__(self, "device_classes", (DeviceClass(
                DEFAULT_CLASS, self.nodes, self.gpus_per_node,
                self.hbm_per_gpu),))
        else:
            object.__setattr__(self, "device_classes",
                               tuple(self.device_classes))
        names = [dc.name for dc in self.device_classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device-class names: {names}")

    @property
    def hetero(self) -> bool:
        """Class-aware paths required: more than one device class, or a
        single EXPLICIT class (anything not named "default" — the shim's
        synthesized class).  A lone explicit class still needs its own
        hardware constants (speed_hint, hbm_per_gpu) honored end to end;
        only the legacy shim reduces to the historical single-pool
        behavior."""
        return len(self.device_classes) > 1 or \
            self.device_classes[0].name != DEFAULT_CLASS

    @property
    def total_gpus(self) -> int:
        return sum(dc.total_gpus for dc in self.device_classes)

    def class_named(self, name: str) -> DeviceClass:
        for dc in self.device_classes:
            if dc.name == name:
                return dc
        raise KeyError(f"no device class {name!r} "
                       f"(have {[d.name for d in self.device_classes]})")

    def device_ranges(self):
        """Contiguous global device-id range per class, in declaration
        order: ``{class_name: (start, stop)}``."""
        out, off = {}, 0
        for dc in self.device_classes:
            out[dc.name] = (off, off + dc.total_gpus)
            off += dc.total_gpus
        return out

    def class_of_device(self, device: int) -> str:
        for name, (lo, hi) in self.device_ranges().items():
            if lo <= device < hi:
                return name
        raise KeyError(f"device {device} outside cluster "
                       f"(total {self.total_gpus})")


def hpo_grid(models, lrs, batch_sizes, *, seq_len: int, total_steps: int,
             steps_scale=None) -> list:
    """Build the paper-style model-selection workload (Table 1 grid)."""
    jobs = []
    for mname, cfg in models:
        for lr in lrs:
            for bs in batch_sizes:
                steps = total_steps
                if steps_scale:
                    steps = int(total_steps * steps_scale.get(mname, 1.0))
                jobs.append(Job(
                    name=f"{mname}-lr{lr:g}-bs{bs}", cfg=cfg,
                    batch_size=bs, seq_len=seq_len,
                    total_steps=steps, lr=lr, seed=len(jobs)))
    return jobs
