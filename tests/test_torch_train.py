"""The port's training path against the JAX package's, on the CPU:
``SyntheticLM`` batches, ``_ce_from_logits``, one ``make_train_step``
step (plain, remat, two microbatches) on xlstm-micro and on
gemma3-4b.reduced(), a 20-step loss trajectory on xlstm-micro,
``BuiltJob`` and the ``launch.train`` command line.

Weights are the JAX package's init carried across; gemma3-4b's wq, wk
and wv are rescaled to a fan-in of d_model, as in
tests/test_torch_model.py (the raw init makes attention chaotic: one
step's grad_norm then differs by 20% between the packages).  The
optimizer runs at lr 1e-3 from step 0 (warmup 1), so that every
parameter moves by about 1e-3 in the step.

Tolerances, each about ten times the largest error measured on the CPU:
- SyntheticLM: bit-identical.
- _ce_from_logits: the loss rtol 1e-6; the perplexity rtol 2e-5, since
  exp multiplies the loss's relative error by the loss, about 10 here
  (measured 1.9e-6).
- One step: metrics rtol 1e-5 (measured: loss equal or 1 ulp,
  grad_norm 5e-7 relative); parameters and optimizer moments atol 1e-4
  on xlstm-micro (measured 1.2e-5) and 5e-4 on gemma3-4b (measured
  5.3e-5), against a move of 1e-3 a step.
- The 20-step trajectory: losses within 2e-5 (measured 1.9e-6; ROADMAP
  A4 asked for about 1e-4).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params, np32
from test_torch_model import _rescale
from repro.checkpoint.store import _flatten_with_paths
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as jt
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.train.steps import _ce_from_logits as jax_ce
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint.store import verify_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.library import ParallelismLibrary
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.models.params import params_to_numpy
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.parallelism.build import BuiltJob
from repro_torch.train.steps import _ce_from_logits, lm_loss, make_train_step

ROOT = Path(__file__).resolve().parents[1]
MICRO = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             name="xlstm-micro")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
PARAM_ATOL = {"xlstm-micro": 1e-4, "gemma3-4b": 5e-4}


def _cfgs(name):
    if name == "xlstm-micro":
        return (dataclasses.replace(
                    jax_get_config("xlstm-125m").reduced(), **MICRO),
                dataclasses.replace(get_config("xlstm-125m").reduced(),
                                    **MICRO))
    return jax_get_config(name).reduced(), get_config(name).reduced()


def _setup(name):
    jcfg, cfg = _cfgs(name)
    jparams = jt.init_model(jcfg, jax.random.PRNGKey(1))
    if name != "xlstm-micro":
        jparams = _rescale(jcfg, jparams)
    return jcfg, cfg, jparams


# ------------------------------------------------------------------ data

FRONTENDS = {"text": "xlstm-125m", "vision": "internvl2-1b",
             "audio": "musicgen-medium"}


@pytest.mark.parametrize("frontend", list(FRONTENDS))
def test_synthetic_batches_bit_identical(frontend):
    jcfg, cfg = (jax_get_config(FRONTENDS[frontend]).reduced(),
                 get_config(FRONTENDS[frontend]).reduced())
    assert cfg.frontend == {"text": None}.get(frontend, frontend)
    want = list(JaxSyntheticLM(jcfg, seed=3).batches(2, 16, num_batches=3))
    got = list(SyntheticLM(cfg, seed=3).batches(2, 16, num_batches=3,
                                                device="cpu"))
    skipped = next(SyntheticLM(cfg, seed=3).batches(2, 16, skip=2,
                                                    device="cpu"))
    for w, g in zip(want + want[2:], got + [skipped]):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == (torch.int32 if k != "embeds"
                                  else torch.float32)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("frontend", list(FRONTENDS))
def test_ce_from_logits_matches_jax(frontend):
    jcfg, cfg = (jax_get_config(FRONTENDS[frontend]).reduced(),
                 get_config(FRONTENDS[frontend]).reduced())
    batch = next(SyntheticLM(cfg, seed=0).batches(2, 16, device="cpu"))
    s = 16 if frontend != "vision" else batch["embeds"].shape[1] + \
        batch["tokens"].shape[1]
    logits = np.random.RandomState(1).randn(
        2, s, cfg.vocab_size).astype(np.float32) * 3
    jloss, jm = jax_ce(jcfg, logits, {k: v.numpy() for k, v in
                                      batch.items()})
    loss, m = _ce_from_logits(cfg, torch.tensor(logits), batch)
    np.testing.assert_allclose(np32(loss), np32(jloss), rtol=1e-6)
    np.testing.assert_allclose(np32(m["perplexity"]), np32(jm["perplexity"]),
                               rtol=2e-5)


# ------------------------------------------------------------ train step

def _compare_trees(got, want, atol, what):
    got, want = params_to_numpy(got), _flatten_with_paths(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=f"{what}/{k}")


@pytest.mark.parametrize("variant", ["plain", "remat", "microbatches"])
@pytest.mark.parametrize("name", ["xlstm-micro", "gemma3-4b"])
def test_train_step_matches_jax(name, variant):
    jcfg, cfg, jparams = _setup(name)
    kw = {"plain": {}, "remat": {"remat": True},
          "microbatches": {"microbatches": 2}}[variant]
    jbatch = next(JaxSyntheticLM(jcfg, seed=0).batches(2, 32))
    batch = next(SyntheticLM(cfg, seed=0).batches(2, 32, device="cpu"))
    params = jax_to_torch_params(jparams)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**OPT), **kw))
    jp, jo, jm = jstep(jparams, jax_init_opt_state(jparams), jbatch)
    p, o, m = make_train_step(cfg, AdamWConfig(**OPT), **kw)(
        params, init_opt_state(params), batch)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np32(m[k]), np32(jm[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert int(o["step"]) == int(jo["step"]) == 1
    _compare_trees(p, jp, PARAM_ATOL[name], "params")
    _compare_trees({"mu": o["mu"], "nu": o["nu"]},
                   {"mu": jo["mu"], "nu": jo["nu"]}, PARAM_ATOL[name], "opt")


def test_loss_trajectory_matches_jax():
    """20 steps on xlstm-micro, a new SyntheticLM batch each step."""
    jcfg, cfg, jparams = _setup("xlstm-micro")
    params = jax_to_torch_params(jparams)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**OPT)))
    step = make_train_step(cfg, AdamWConfig(**OPT))
    jopt, opt = jax_init_opt_state(jparams), init_opt_state(params)
    jdata = JaxSyntheticLM(jcfg, seed=0).batches(2, 32, num_batches=20)
    data = SyntheticLM(cfg, seed=0).batches(2, 32, num_batches=20,
                                            device="cpu")
    jl, tl = [], []
    for jb, b in zip(jdata, data):
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        params, opt, m = step(params, opt, b)
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    assert len(tl) == 20
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=0)


def test_lm_loss_runs_the_plain_path(monkeypatch):
    """opts=None means {} in training, never the kernels' kernel_opts."""
    def refuse(device):
        raise AssertionError("training reached kernel_opts")
    monkeypatch.setattr(transformer, "kernel_opts", refuse)
    _, cfg = _cfgs("xlstm-micro")
    params = transformer.init_model(cfg, seed=0, device="cpu")
    batch = next(SyntheticLM(cfg).batches(2, 8, device="cpu"))
    loss, _ = lm_loss(params, cfg, batch)
    assert bool(torch.isfinite(loss))
    with pytest.raises(AssertionError, match="kernel_opts"):
        transformer.forward(params, cfg, batch)


# -------------------------------------------------------------- BuiltJob

def _plan(technique, n, cfg):
    return ParallelismLibrary().get(technique).plan(cfg, n)


@pytest.mark.parametrize("technique,n", [("tp", 2), ("gpipe", 2),
                                         ("fsdp", 2), ("ddp", 2),
                                         ("remat-offload", 4)])
def test_built_job_refuses_what_is_not_ported(technique, n):
    """Without a process group BuiltJob runs one device: a plan of n > 1
    devices asks for the group its n ranks run in
    (tests/test_torch_parallelism.py runs them)."""
    _, cfg = _cfgs("xlstm-micro")
    with pytest.raises(ValueError, match="ranks of a process group"):
        BuiltJob(cfg, _plan(technique, n, cfg), AdamWConfig(), device="cpu")


def test_built_job_ddp_and_remat_offload_agree():
    """One step at each single-device technique from BuiltJob.init:
    remat recomputes the same activations, so the CPU results are
    bit-equal."""
    _, cfg = _cfgs("xlstm-micro")
    batch = next(SyntheticLM(cfg).batches(2, 16, device="cpu"))
    out = {}
    for technique in ("ddp", "remat-offload"):
        plan = _plan(technique, 1, cfg)
        job = BuiltJob(cfg, plan, AdamWConfig(**OPT), device="cpu")
        assert plan.remat == (technique == "remat-offload")
        params, opt = job.init(0)
        init = transformer.init_model(cfg, seed=0, device="cpu")
        for a, b in zip(params_to_numpy(params).values(),
                        params_to_numpy(init).values()):
            np.testing.assert_array_equal(a, b)
        out[technique] = job.step(params, opt, job.place_batch(batch))
    (pa, oa, ma), (pb, ob, mb) = out.values()
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(params_to_numpy({"p": pa, "o": oa}).values(),
                    params_to_numpy({"p": pb, "o": ob}).values()):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- CLI

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xlstm-125m", "--reduced", "--device", "cpu", "--technique", "ddp",
         "--devices", "1", "--batch", "2", "--seq", "16", "--log-every", "1",
         *args], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    first = _cli("--steps", "3", "--ckpt", ckpt)
    assert first.returncode == 0, first.stderr
    lines = [ln for ln in first.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3 and all("ms/step" in ln for ln in lines)
    assert verify_checkpoint(ckpt)["step"] == 3
    second = _cli("--steps", "5", "--ckpt", ckpt, "--resume")
    assert second.returncode == 0, second.stderr
    assert f"resumed from {ckpt} at step 3" in second.stdout
    lines = [ln for ln in second.stdout.splitlines() if ln.startswith("step")]
    assert [ln.split()[1] for ln in lines] == ["4", "5"]
    assert verify_checkpoint(ckpt)["step"] == 5
    assert verify_checkpoint(ckpt + ".prev")["step"] == 3


def test_cli_default_technique_exits_at_one_device():
    """fsdp, the default, needs two devices, as in the JAX launcher."""
    with pytest.raises(SystemExit, match="fsdp invalid for xlstm-125m-smoke "
                                         "at 1 devices"):
        launch_train.main(["--arch", "xlstm-125m", "--reduced", "--device",
                           "cpu", "--devices", "1", "--steps", "1"])
