"""Saturn's loop in the port, on the CPU: the Trial Runner, the local
execution backend and the session (src/repro_torch/core/{profiler,
local_backend,api}.py), on xlstm-micro (d_model 64, 2 heads, batch 2 x
seq 32, as benchmarks/run.py's e2e scenarios run it).

- Empirical trials record ddp x1 and remat-offload x1 feasible, and
  tp x1 (outside its search space) and ddp x2 (the port's BuiltJob
  raises NotImplementedError, a RuntimeError) infeasible.
- The analytic mode and the roofline strategy raise, naming ROADMAP A12.
- Napkin profiles equal the JAX package's exactly (the same closed form
  over the same parameter counts), and the profile cache round-trips
  through the JAX package's JSON both ways.
- Both of ``bench_e2e``'s scenarios pass on
  ``LocalTorchBackend(devices=["cpu", "cpu"])`` with the benchmark's own
  asserts; the port runs one device a job, so the restart scenario flips
  j0 from ddp x1 to remat-offload x1, as the benchmark does on one
  device.  Step counts are sized from the measured trial, as the
  benchmark's ``steps_for`` does, but for seconds rather than minutes.
- One job run through the port's and the JAX package's local backends
  under the same fixed two-segment schedule (ddp x1 for 4 steps, then
  remat-offload x1 for 4 more from the checkpoint), from the same
  start checkpoint, gives per-step losses within atol 2e-5, the
  tolerance of tests/test_torch_train.py's 20-step trajectory.
- A session trains two jobs through backend="local"; backend="process"
  raises, naming ROADMAP A6.
- The portfolio's forked MILP leg completes while a torch worker thread
  trains.

Torch runs two intra-op threads (tests/_torch_port.py), so that the
worker threads of a run share the machine as the suite's other workers
do.
"""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest

import _torch_port  # noqa: F401  (thread cap)
from repro.checkpoint.store import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.core.job import Job as JJob
from repro.core.library import ParallelismLibrary as JLibrary
from repro.core.local_backend import LocalJaxBackend
from repro.core.profiler import HARDWARE as JHARDWARE
from repro.core.profiler import TrialRunner as JTrialRunner
from repro.core.schedule import Placement as JPlacement
from repro.core.schedule import ScheduleEntry as JEntry
from repro.parallelism.build import BuiltJob as JBuiltJob
from repro.parallelism.techniques import DDP as JDDP
from repro.parallelism.techniques import RematOffload as JRematOffload
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.api import SaturnSession
from repro_torch.core.baselines import CurrentPractice, SaturnStatic
from repro_torch.core.chaos import RetryPolicy
from repro_torch.core.executor import LocalRunner, simulate
from repro_torch.core.job import ClusterSpec, Job
from repro_torch.core.library import ParallelismLibrary
from repro_torch.core.local_backend import LocalTorchBackend
from repro_torch.core.portfolio import join_stragglers, solve_portfolio
from repro_torch.core.profiler import (HARDWARE, Profile, TrialRunner,
                                       hardware_from_device)
from repro_torch.core.schedule import (Placement, Policy, Schedule,
                                       ScheduleEntry)
from repro_torch.core.solver import Choice, greedy_schedule, objective_value
from repro_torch.core.lns import validate_capacity
from repro_torch.parallelism.techniques import DDP, TP, RematOffload

MICRO = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             name="xlstm-micro")
CFG = dataclasses.replace(get_config("xlstm-125m").reduced(), **MICRO)
JCFG = dataclasses.replace(jax_get_config("xlstm-125m").reduced(), **MICRO)
CPUS = ["cpu", "cpu"]
LOSS_ATOL = 2e-5       # tests/test_torch_train.py's trajectory tolerance


def _lib():
    return ParallelismLibrary([DDP(), RematOffload()])


@pytest.fixture(scope="module")
def probes():
    """Empirical trials of the e2e probe job: (runner, ddp x1,
    remat-offload x1)."""
    runner = TrialRunner(ParallelismLibrary([DDP(), RematOffload(), TP()]),
                         HARDWARE["a100"], device="cpu", devices=CPUS)
    probe = Job("probe", CFG, 2, 32, total_steps=1)
    return (runner, runner.profile(probe, "ddp", 1, mode="empirical"),
            runner.profile(probe, "remat-offload", 1, mode="empirical"))


def test_empirical_trials_record_feasibility(probes):
    runner, ddp, remat = probes
    probe = Job("probe", CFG, 2, 32, total_steps=1)
    for p in (ddp, remat):
        assert p.feasible and p.source == "empirical"
        assert 0 < p.step_time_s < 30 and math.isfinite(p.mem_per_device)
    tp = runner.profile(probe, "tp", 1, mode="empirical")
    ddp2 = runner.profile(probe, "ddp", 2, mode="empirical")
    assert not tp.feasible and tp.step_time_s == float("inf")
    assert not ddp2.feasible and ddp2.terms == {"trial_error": 1.0}
    assert runner.trials == 3          # tp x1 is never tried
    # the cache answers a repeat without a new trial
    assert runner.profile(probe, "ddp", 1, mode="empirical") is ddp
    assert runner.trials == 3


def test_empirical_trial_needs_the_devices():
    runner = TrialRunner(_lib(), device="cpu")
    with pytest.raises(RuntimeError, match="needs 2 local devices"):
        runner.profile(Job("p", CFG, 2, 32, 1), "ddp", 2, mode="empirical")


def test_hlo_modes_raise_naming_a12():
    runner = TrialRunner(_lib(), device="cpu")
    job = Job("p", CFG, 2, 32, 1)
    with pytest.raises(NotImplementedError, match="A12"):
        runner.profile(job, "ddp", 1)                 # mode="analytic"
    with pytest.raises(NotImplementedError, match="A12"):
        runner.profile_all([job], [1], mode="empirical",
                            strategy="roofline")
    with pytest.raises(NotImplementedError, match="A12"):
        runner.profile_all([job], [1], mode="analytic")
    with pytest.raises(ValueError, match="CUDA device"):
        hardware_from_device("cpu")


NAPKIN_ARCHS = [a for a in ARCH_IDS
                if get_config(a).moe is None]


def _napkin_jobs(pkg_get_config, JobCls):
    return [JobCls(f"{a}-{i}", pkg_get_config(a), b, s, 100)
            for i, (b, s) in enumerate([(8, 512), (32, 2048)])
            for a in NAPKIN_ARCHS]


def test_napkin_profiles_equal_the_reference():
    counts = [1, 2, 4, 8, 16]
    port = TrialRunner(ParallelismLibrary(), HARDWARE["a100"])
    ref = JTrialRunner(JLibrary(), JHARDWARE["a100"])
    a = port.profile_all(_napkin_jobs(get_config, Job), counts,
                         mode="napkin", workers=1)
    b = ref.profile_all(_napkin_jobs(jax_get_config, JJob), counts,
                        mode="napkin", workers=1)
    assert len(a) == len(b) > 100
    assert {k: dataclasses.asdict(v) for k, v in a.items()} == \
        {k: dataclasses.asdict(v) for k, v in b.items()}
    # interpolate: the same anchors, the same curve values
    pa = port.profile_all(_napkin_jobs(get_config, Job), counts,
                          mode="napkin", strategy="interpolate", workers=1)
    pb = ref.profile_all(_napkin_jobs(jax_get_config, JJob), counts,
                         mode="napkin", strategy="interpolate", workers=1)
    keys = sorted(b)
    assert [pa[k].step_time_s for k in keys] == \
        [pb[k].step_time_s for k in keys]


def test_napkin_moe_is_not_ported_yet():
    moe = [a for a in ARCH_IDS if get_config(a).moe is not None]
    assert moe
    with pytest.raises(NotImplementedError, match="A8"):
        TrialRunner(ParallelismLibrary()).profile(
            Job("m", get_config(moe[0]), 8, 512, 100), "ddp", 1, "napkin")


def test_profile_cache_round_trips_through_the_reference(tmp_path, probes):
    _, ddp, remat = probes
    path = str(tmp_path / "profiles.json")
    port = TrialRunner(_lib(), cache_path=path, device="cpu")
    jobs = _napkin_jobs(get_config, Job)[:3]
    napkin = port.profile_all(jobs, [1, 2], mode="napkin", workers=1)
    with port._lock:                  # the empirical trials too
        for p in (ddp, remat):
            port._cache[(p.job, p.technique, p.n_devices, p.source,
                         p.device_class)] = p
        port._dirty += 1
    port.flush()
    ref = JTrialRunner(JLibrary(), cache_path=path)
    got = {k: ref.profile(JJob(k[0], jax_get_config(k[0].rsplit("-", 1)[0]),
                               8, 512, 100), k[1], k[2], "napkin")
           for k in napkin}
    assert ref.trials == 0
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in napkin.items()}
    jprobe = JJob("probe", JCFG, 2, 32, 1)
    assert dataclasses.asdict(ref.profile(jprobe, "ddp", 1, "empirical")) \
        == dataclasses.asdict(ddp)
    # and back: the reference's rewrite loads in the port
    ref._dirty += 1
    ref.flush()
    again = TrialRunner(_lib(), cache_path=path, device="cpu")
    assert dataclasses.asdict(again.profile(
        Job("probe", CFG, 2, 32, 1), "remat-offload", 1, "empirical")) == \
        dataclasses.asdict(remat)
    assert again.trials == 0


# ------------------------------------------------ bench_e2e's scenarios

def _mk_profiles(jobs, ddp, remat):
    out = {}
    for j in jobs:
        for p in (ddp, remat):
            out[(j.name, p.technique, 1)] = Profile(
                j.name, p.technique, 1, p.step_time_s, p.mem_per_device,
                p.feasible, p.source)
    return out


def _steps_for(est, seconds, lo):
    return max(lo, int(seconds / max(est, 1e-4)))


E2E_CLUSTER = ClusterSpec(nodes=1, gpus_per_node=2, restart_cost_s=1.0)


def test_e2e_fidelity_scenario(tmp_path, probes):
    """Scenario 1 of bench_e2e: one static plan, predicted by the
    SimBackend and executed by LocalTorchBackend."""
    _, ddp, remat = probes
    est = ddp.step_time_s
    jobs = [Job(f"j{i}", CFG, 2, 32,
                total_steps=_steps_for(est, s, 20), lr=lr, seed=i)
            for i, (s, lr) in enumerate([(1.6, 1e-3), (1.0, 3e-4),
                                         (1.0, 1e-3)])]
    profiles = _mk_profiles(jobs, ddp, remat)
    predicted = simulate(jobs, SaturnStatic(time_limit_s=10), profiles,
                         E2E_CLUSTER, noise_sigma=0.0)
    be = LocalTorchBackend(library=_lib(), ckpt_dir=str(tmp_path),
                           devices=CPUS)
    executed = simulate(jobs, SaturnStatic(time_limit_s=10), profiles,
                        E2E_CLUSTER, noise_sigma=0.0, exec_backend=be)
    for j in jobs:
        segs = executed.stats[j.name]["segments"]
        assert sum(s["steps"] for s in segs) == j.total_steps, j.name
    ratio = executed.makespan_s / predicted.makespan_s
    assert 0.1 <= ratio <= 8.0, f"fidelity ratio {ratio:.2f} out of band"
    # the plan ran two jobs side by side on the two devices
    runs = [g for g in executed.gantt if g.kind == "run"]
    assert {g.devices for g in runs} == {(0,), (1,)}


class FlipWhenProgressed(Policy):
    """bench_e2e's restart policy at one device a job: j0 flips from
    ddp x1 to remat-offload x1 at the first replan that sees progress."""

    name = "flip"
    dynamic = True
    replan_on_completion = False

    def __init__(self, target, total):
        self.target, self.total = target, total
        self.flipped = False

    def entry(self, name):
        if name == self.target and self.flipped:
            return ("remat-offload", 1)
        return ("ddp", 1)

    def plan(self, jobs_, remaining, _profiles, _cluster, current):
        if remaining.get(self.target, self.total) < self.total:
            self.flipped = True
        return Schedule([ScheduleEntry(j.name, *self.entry(j.name))
                         for j in jobs_])


def test_e2e_restart_scenario(tmp_path, probes):
    """Scenario 2 of bench_e2e: an introspection replan preempts the
    REALLY-training j0, which checkpoints, pays the restart penalty and
    resumes from the saved step with the data stream continued."""
    _, ddp, remat = probes
    est = ddp.step_time_s
    long_steps = _steps_for(est, 3.0, 40)
    jobs = [Job("j0", CFG, 2, 32, total_steps=long_steps, lr=1e-3,
                seed=0)] + \
        [Job(f"j{i}", CFG, 2, 32, total_steps=_steps_for(est, 0.5, 10),
             lr=1e-3, seed=i) for i in (1, 2)]
    be = LocalTorchBackend(library=_lib(), ckpt_dir=str(tmp_path),
                           devices=CPUS)
    res = simulate(jobs, FlipWhenProgressed("j0", long_steps),
                   _mk_profiles(jobs, ddp, remat), E2E_CLUSTER,
                   noise_sigma=0.0, introspect_every_s=0.5,
                   exec_backend=be)
    segs = res.stats["j0"]["segments"]
    for a, b in zip(segs, segs[1:]):
        assert b["start_step"] == a["start_step"] + a["steps"], \
            "resume did not continue from the checkpointed step"
    assert res.restarts >= 1, "no mid-run restart was exercised"
    assert segs[0]["steps"] > 0 and len(segs) >= 2
    assert sum(s["steps"] for s in segs) == long_steps
    assert segs[0]["technique"] == "ddp"
    assert segs[-1]["technique"] == "remat-offload"
    losses = res.stats["j0"]["losses"]
    assert all(math.isfinite(v) for _, v in losses)
    assert [s for s, _ in losses] == list(range(1, long_steps + 1))
    assert be.observed, \
        "measured step times must feed the introspection replans"


# --------------------------------- the two backends, one fixed schedule

SEGMENTS = (("ddp", 4), ("remat-offload", 4))


def _run_segments(be, job, entry_cls, placement_cls, profiles, cluster):
    be.bind([job], profiles, cluster)
    remaining = job.total_steps
    for tech, steps in SEGMENTS:
        h = be.launch(job, entry_cls(job.name, tech, 1), placement_cls((0,)),
                      "default", steps, be.now(), 0)
        be.complete(h, be.now())
        remaining -= steps
    assert remaining == 0
    return be.result_stats()[job.name]


def test_losses_match_local_jax_backend_across_a_resume(tmp_path,
                                                       monkeypatch):
    """Both backends start from the JAX package's init, written as a
    step-0 checkpoint that each resumes from; the second segment
    resumes from the first one's checkpoint under another technique."""
    monkeypatch.setenv("SATURN_COMPILE_CACHE", str(tmp_path / "xla"))
    total = sum(n for _, n in SEGMENTS)
    jjob = JJob("j0", JCFG, 2, 32, total_steps=total, lr=1e-3, seed=0)
    job = Job("j0", CFG, 2, 32, total_steps=total, lr=1e-3, seed=0)
    jlib = JLibrary([JDDP(), JRematOffload()])
    params, opt = JBuiltJob(JCFG, jlib.get("ddp").plan(JCFG, 1),
                            jjob.opt_cfg).init(jax.random.PRNGKey(0))
    stats = {}
    for name, be, j, entry, place in (
            ("jax", LocalJaxBackend(library=jlib, resume=True,
                                    ckpt_dir=str(tmp_path / "jax")),
             jjob, JEntry, JPlacement),
            ("torch", LocalTorchBackend(library=_lib(), resume=True,
                                        ckpt_dir=str(tmp_path / "torch"),
                                        devices=["cpu"]),
             job, ScheduleEntry, Placement)):
        os.makedirs(be.ckpt_dir)
        jax_save_checkpoint(os.path.join(be.ckpt_dir, "j0.npz"),
                            {"params": params, "opt": opt},
                            {"step": 0, "loss": float("nan")})
        stats[name] = _run_segments(be, j, entry, place, {},
                                    ClusterSpec(nodes=1, gpus_per_node=1))
    for st in stats.values():
        assert [(s["technique"], s["start_step"], s["steps"])
                for s in st["segments"]] == [("ddp", 0, 4),
                                             ("remat-offload", 4, 4)]
    steps = [s for s, _ in stats["torch"]["losses"]]
    assert steps == [s for s, _ in stats["jax"]["losses"]] == \
        list(range(1, total + 1))
    np.testing.assert_allclose([v for _, v in stats["torch"]["losses"]],
                               [v for _, v in stats["jax"]["losses"]],
                               atol=LOSS_ATOL, rtol=0)


def test_worker_failure_quarantines_an_unported_plan(tmp_path):
    """A plan the port does not run (ddp x2) raises NotImplementedError
    inside the worker: the engine sees a worker failure, retries under
    its budget, then quarantines the job with the reason."""
    jobs = [Job("j0", CFG, 2, 32, total_steps=10, lr=1e-3, seed=0)]
    profiles = {("j0", "ddp", 2): Profile("j0", "ddp", 2, 0.01, 1e9, True,
                                          "t")}
    be = LocalTorchBackend(library=_lib(), ckpt_dir=str(tmp_path),
                           devices=CPUS,
                           retry_policy=RetryPolicy(budget=1, base_s=0.1,
                                                    cap_s=0.2, jitter=0.0))
    res = simulate(jobs, CurrentPractice(), profiles, E2E_CLUSTER,
                   exec_backend=be)
    assert res.worker_failures == 2
    assert "retry budget exhausted" in res.quarantined["j0"]
    assert "not ported yet" in res.quarantined["j0"]


def test_bind_refuses_a_cluster_larger_than_its_devices():
    be = LocalTorchBackend(devices=["cpu"])
    with pytest.raises(RuntimeError, match="asks for 2 devices"):
        be.bind([], {}, E2E_CLUSTER)


def test_local_runner_resume_matches_uninterrupted(tmp_path):
    """LocalRunner, the serial building block: 5 steps, a checkpoint,
    then the rest from it, against 8 straight steps (the JAX package's
    tests/test_checkpoint_resume.py); on one CPU thread of control the
    two runs are bit-equal."""
    job = Job("cont", CFG, 2, 32, total_steps=8, lr=1e-3, seed=0)
    tech = _lib().get("ddp")
    full = LocalRunner(["cpu"], str(tmp_path / "a")).run_job(
        job, tech, 1, resume=False)
    half = LocalRunner(["cpu"], str(tmp_path / "b"))
    first = half.run_job(job, tech, 1, steps=5, resume=False)
    rest = half.run_job(job, tech, 1)
    assert first["steps"] == 5 and not first["done"]
    assert rest["steps"] == 3 and rest["done"]
    assert rest["loss"] == full["loss"] != first["loss"]
    a = dict(np.load(str(tmp_path / "a" / "cont.npz")))
    b = dict(np.load(str(tmp_path / "b" / "cont.npz")))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert full["step_time_s"] == full["wall_s"] / (full["steps"] - 1)


# ---------------------------------------------------------- the session

def test_session_trains_two_jobs_locally(tmp_path):
    sess = SaturnSession(E2E_CLUSTER, library=_lib(), device="cpu")
    jobs = sess.submit([Job(f"j{i}", CFG, 2, 32, total_steps=12, lr=lr,
                            seed=i) for i, lr in enumerate([1e-3, 3e-4])])
    profiles = sess.profile(mode="empirical", strategy="exhaustive")
    assert sess.gpu_counts() == [1, 2]
    assert {k: p.feasible for k, p in profiles.items()} == {
        (j.name, t, g): g == 1 for j in jobs
        for t in ("ddp", "remat-offload") for g in (1, 2)}
    res = sess.run(backend="local", introspect_every_s=1.0,
                   ckpt_dir=str(tmp_path), time_limit_s=5)
    for j in jobs:
        st = res.stats[j.name]
        assert sum(s["steps"] for s in st["segments"]) == j.total_steps
        assert all(math.isfinite(v) for _, v in st["losses"])
        assert os.path.exists(tmp_path / f"{j.name}.npz")
    assert res.makespan_s > 0 and res.replans >= 1
    with pytest.raises(NotImplementedError, match="A6"):
        sess.run(backend="process")
    with pytest.raises(ValueError):
        sess.run(backend="remote")


def test_session_simulates_from_napkin_profiles():
    sess = SaturnSession(ClusterSpec(nodes=1, gpus_per_node=8))
    sess.submit([Job(f"j{i}", get_config("xlstm-125m"), 8, 512, 1000)
                 for i in range(3)])
    sess.profile(mode="napkin")
    res = sess.run(backend="sim", time_limit_s=5)
    assert res.makespan_s > 0
    assert {g.job for g in res.gantt} == {"j0", "j1", "j2"}


# ------------------------------------------- the fork after torch threads

def test_portfolio_fork_completes_while_a_worker_trains(tmp_path):
    """The race forks a child for the MILP leg while a torch worker
    thread trains in the parent: the race still returns a feasible
    plan, and the worker finishes its budget."""
    job = Job("w", CFG, 2, 32, total_steps=10**6, lr=1e-3, seed=0)
    be = LocalTorchBackend(library=_lib(), ckpt_dir=str(tmp_path),
                           devices=["cpu"])
    be.bind([job], {}, ClusterSpec(nodes=1, gpus_per_node=1))
    h = be.launch(job, ScheduleEntry("w", "ddp", 1), Placement((0,)),
                  "default", job.total_steps, 0.0, 0)
    try:
        while h.worker.steps_done < 2 and not h.worker.done.is_set():
            h.worker.done.wait(0.05)
        rng = np.random.RandomState(0)
        jobs, cm = [], {}
        for i in range(12):
            j = Job(f"j{i}", CFG, 8, 64, int(rng.randint(150, 500)))
            jobs.append(j)
            base, eff = rng.uniform(1.0, 4.0), rng.uniform(0.5, 0.95)
            cm[j.name] = [Choice("ddp", g, base * j.total_steps / g ** eff)
                          for g in (1, 2, 4, 8, 16)]
        budgets = {None: 16}
        sol = solve_portfolio(jobs, cm, budgets, wall_budget_s=2.0)
        join_stragglers()
        assert {a.job for a in sol.assignments} == {j.name for j in jobs}
        assert validate_capacity(sol.assignments, budgets)
        assert objective_value(sol.assignments, jobs, "makespan") <= \
            greedy_schedule(jobs, cm, budgets).makespan_s + 1e-6
        # a forked child that died would report "error"
        assert all(e.get("status") != "error"
                   for e in sol.telemetry["engines"].values())
        assert h.worker.error is None and not h.worker.done.is_set()
    finally:
        done = be.preempt(h, be.now())
    assert done >= 2 and h.worker.preempted
