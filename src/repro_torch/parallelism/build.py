"""Turn a (model config, Plan) pair into an executable: parameters and
optimizer state on a device, and a train step.  Used by the launch path.

Single-device for now: ``ddp`` and ``remat-offload`` at one device,
where remat-offload's ``param_policy="fsdp"`` shards over one device,
which is replication.  Every other plan raises rather than run a
single-device step in its place.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import init_params
from ..models.transformer import model_spec
from ..optim.adamw import AdamWConfig, init_opt_state
from ..train.steps import make_train_step
from .base import Plan

SINGLE_DEVICE_TECHNIQUES = ("ddp", "remat-offload")


class BuiltJob:
    """Executable artifact for one (model, technique, n_devices) choice."""

    def __init__(self, cfg: ModelConfig, plan: Plan, opt_cfg: AdamWConfig,
                 device="cuda"):
        if plan.n_devices > 1:
            raise NotImplementedError(
                f"{plan.technique} at {plan.n_devices} devices: multi-device "
                "execution is not ported yet (ROADMAP A11)")
        if plan.technique not in SINGLE_DEVICE_TECHNIQUES:
            raise NotImplementedError(
                f"technique {plan.technique!r} is not ported yet "
                "(ROADMAP A11)")
        self.cfg, self.plan, self.opt_cfg = cfg, plan, opt_cfg
        self.device = resolve_device(device)
        self.spec_tree = model_spec(cfg)
        self._step = None

    @property
    def step(self):
        """train_step(params, opt_state, batch) -> (params, opt, metrics)
        on the model's plain paths, with the plan's remat."""
        if self._step is None:
            self._step = make_train_step(self.cfg, self.opt_cfg,
                                         remat=self.plan.remat)
        return self._step

    def init(self, seed: int = 0, dtype=torch.float32):
        """Parameters from ``seed`` and a zero optimizer state."""
        params = init_params(self.spec_tree, seed, dtype, self.device)
        return params, init_opt_state(params)

    def place_batch(self, batch):
        return {k: v.to(self.device) for k, v in batch.items()}
