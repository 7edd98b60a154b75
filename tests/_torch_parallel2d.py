"""Shared by tests/test_torch_parallel2d_*.py: the dry run's 2-D and 3-D
rules plans (``repro_torch.testing.parallel_check.rules_plan``) on four
gloo ranks, held against the JAX package on one device.

Each arch spawns its four ranks once, and they run both meshes
(``parallel_check.rules_runs_on``): on each, one train step without and
with remat, then a prefill.  The meshes are (data 2, model 2), where "embed" is cut
over data and gathered just in time while the heads, ffn, experts,
vocab and rnn channels that divide are cut over model, and (pod 2,
data 1, model 2), where the batch is cut over the tuple ("pod", "data")
and data's one rank cuts nothing.  The weights are the JAX init with
wq, wk and wv rescaled (tests/test_torch_families.py says why), the
batch ``concrete_batch`` (B 8 x S 32), the optimizer parallel_check's.

- train: the loss, grad_norm and the other metrics at RTOL 1e-5, the
  parameters and AdamW's mu and nu at PARAM_ATOL 5e-4
  (tests/test_torch_parallelism.py);
- prefill: each rank's last logits, its rows of the batch and its
  vocab part where vocab is cut, at LOGITS_ATOL 1e-4
  (tests/test_torch_model.py), and its part of every cache and state
  leaf within STATE_REL 5e-5 of the leaf's largest value.  The sLSTM's
  states carry the most rounding: the one-device port's prefill of
  xlstm-125m at this shape is 1.02e-5 (h) and 8.3e-6 (c) from the
  JAX package's, every other leaf within 2e-6, and the model ranks'
  partial sums add their own rounding (1.06e-5 on c measured).
"""
import jax
import numpy as np

import _torch_port  # noqa: F401  (thread cap)
from _torch_port import np32
from test_torch_model import _rescale
from test_torch_parallelism import (OPT, PARAM_ATOL, RTOL, SPAWN_TIMEOUT_S,
                                    _batch, _cfgs, _close, _jstep)
from repro.checkpoint.store import _flatten_with_paths
from repro.models import transformer as jt
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch.models.params import tree_leaves_with_paths
from repro_torch.models.transformer import state_batch_axes
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallelism.dist import spawn
from repro_torch.testing.parallel_check import (MESHES, expected_part,
                                                rules_runs_on)

LOGITS_ATOL = 1e-4
STATE_REL = 5e-5


class Runs:
    """Each arch's spawn, which runs both meshes in one group of four
    ranks, and the JAX one-device step and prefill from the same
    parameters on the same batch, made on first use."""

    def __init__(self):
        self._done = {}

    def __call__(self, arch, mesh):
        if arch not in self._done:
            self._done[arch] = self._run(arch)
        case = self._done[arch]
        return {**case, "got": case["got"][mesh]}

    @staticmethod
    def _run(arch):
        jcfg, cfg = _cfgs(arch)
        jparams = _rescale(jcfg, jt.init_model(jcfg, jax.random.PRNGKey(1)))
        batch = _batch(jcfg)
        got = spawn(rules_runs_on, ["cpu"] * 4, cfg, AdamWConfig(**OPT),
                    _flatten_with_paths(jparams), batch, MESHES,
                    timeout_s=SPAWN_TIMEOUT_S)
        step = _jstep(jcfg)(jparams, jax_init_opt_state(jparams), batch)
        logits, state = jax.jit(lambda p, b: jt.prefill_forward(
            p, jcfg, b))(jparams, batch)
        return {"cfg": cfg, "got": got, "step": step, "logits": logits,
                "state": state}


def check_step(case, remat):
    """One train step of the rules plan against the JAX step."""
    r = case["got"][remat]
    jp, jo, jm = case["step"]
    assert set(r["metrics"]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(r["metrics"][k], np32(jm[k]), rtol=RTOL,
                                   atol=0, err_msg=k)
    assert r["step"] == int(jo["step"]) == 1
    _close(r["params"], jp, PARAM_ATOL, "params")
    _close(r["mu"], jo["mu"], PARAM_ATOL, "mu")
    _close(r["nu"], jo["nu"], PARAM_ATOL, "nu")


def check_prefill(case, mesh):
    """Every rank's prefill parts against the JAX prefill's slices; the
    parts are cut: on either mesh a rank holds half the batch's rows and
    half the vocab, and its model part of each state leaf that the rules
    cut."""
    mesh_axes = MESHES[mesh]
    cfg = case["cfg"]
    logits = np32(case["logits"])
    full = {k: np32(v) for k, v in
            _flatten_with_paths(case["state"]["layers"]).items()}
    axes = {"/".join(p): a for p, a in
            tree_leaves_with_paths(state_batch_axes(cfg)["layers"])}
    parts = case["got"]["prefill"]
    assert len(parts) == 4
    seen = set()
    for part in parts:
        coords = part["coords"]
        seen.add(tuple(sorted(coords.items())))
        assert part["pos"] == int(case["state"]["pos"])
        b = logits.shape[0] // 2
        assert part["logits"].shape == (b, 1, cfg.vocab_size // 2)
        want = expected_part(logits, part["logits"].shape, coords,
                             mesh_axes, 0)
        np.testing.assert_allclose(part["logits"], want, atol=LOGITS_ATOL,
                                   rtol=0, err_msg=str(coords))
        assert set(part["state"]) == set(full)
        for k, v in part["state"].items():
            assert v.shape[axes[k]] == full[k].shape[axes[k]] // 2, k
            want = expected_part(full[k], v.shape, coords, mesh_axes,
                                 axes[k])
            err = np.abs(v - want).max()
            assert err <= STATE_REL * np.abs(want).max(), \
                (coords, k, err, np.abs(want).max())
    assert len(seen) == 4


def checkpoint_cross(group, cfg, opt_cfg, ckpt_in, ckpt_out, b1, b2):
    """Per rank: the rules plan on (data 2, model 2) resumes from the
    full tree ``ckpt_in`` (each rank cutting its part), steps on ``b1``
    and rank 0 writes the full tree to ``ckpt_out``; then the rules plan
    on (pod 2, data 1, model 2) resumes from it and steps on ``b2``.
    Returns rank 0's second metrics and full parameters."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.store import save_checkpoint
    from repro_torch.models.params import params_to_numpy
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.testing.parallel_check import rules_plan
    out = None
    for mesh, src, dst, b in (("2x2", ckpt_in, ckpt_out, b1),
                              ("2x1x2", ckpt_out, None, b2)):
        job = BuiltJob(cfg, rules_plan(cfg, MESHES[mesh]), opt_cfg,
                       group=group)
        params, opt = job.init(0)
        params, opt, start = job.load(src, params, opt)
        batch = {k: torch.as_tensor(v) for k, v in b.items()}
        params, opt, m = job.step(params, opt, job.place_batch(batch))
        tree = job.full_state(params, opt)
        if dst is not None:
            if tree is not None:
                save_checkpoint(dst, tree, {"step": start + 1})
            dist.barrier()       # the next mesh's ranks read dst
        elif tree is not None:
            out = ({k: float(v) for k, v in m.items()}, start,
                   params_to_numpy(tree["params"]))
    return out

