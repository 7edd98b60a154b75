"""ProcessTorchBackend on the CPU (src/repro_torch/core/process_backend.py,
src/repro_torch/train/process_worker.py), case for case as
tests/test_process_backend.py holds the JAX package's ProcessJaxBackend:
per-job worker processes supervised over pipes, clean multi-process
training, real fault injection (SIGKILL mid-step, stalled heartbeats,
truncated checkpoints) with bit-for-bit verified recovery, quarantine on
budget exhaustion, and crash-then-resume across backend lifetimes.

Beyond the reference's cases:
- the uninterrupted process trajectory equals LocalTorchBackend's on the
  same job bit for bit (tests/test_torch_saturn_loop.py holds
  LocalTorchBackend against the JAX package's local backend): each
  child runs its job as rank 0 of a group of one;
- a job on two devices trains as a gloo group of two spawned ranks, its
  trajectory within the parity bounds of the one-device run; a SIGKILL
  or a hang of rank 1 recovers from the durable checkpoint onto the
  uninterrupted two-rank trajectory, bit for bit, and no rank outlives
  its job; ``SaturnSession.run(backend="process")`` places a job on
  two devices as such a group; a two-device placement whose batch does
  not split fails in the children and is quarantined;
- the Trial Runner's g = 2 empirical trials run in spawned groups;
- a child keeps stepping while the parent runs about a second of LNS
  search in process: each worker has an interpreter of its own (the GIL
  stall of ROADMAP C4 is a property of worker threads).

The module runs torch on one intra-op thread, which every child takes
from the coordinator at launch, so the children and the
LocalTorchBackend worker thread compute the same reductions in the same
order.  The runs are short (40 steps, a
checkpoint every 5, faults deferred to the first one at step 5, as the
reference's tests place them).
"""
import dataclasses
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (thread cap)
from repro_torch.checkpoint.store import verify_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.baselines import CurrentPractice
from repro_torch.core.chaos import ChaosTrace, RetryPolicy, WorkerFault
from repro_torch.core.executor import simulate
from repro_torch.core.api import SaturnSession
from repro_torch.core.job import ClusterSpec, Job
from repro_torch.core.lns import lns_solve
from repro_torch.core.library import ParallelismLibrary
from repro_torch.core.local_backend import LocalTorchBackend
from repro_torch.core.process_backend import (ProcessTorchBackend, _Proc,
                                               _Rank)
from repro_torch.core.profiler import HARDWARE, Profile, TrialRunner
from repro_torch.core.schedule import Placement, ScheduleEntry
from repro_torch.core.solver import Choice
from repro_torch.parallelism.techniques import DDP

CFG = dataclasses.replace(get_config("xlstm-125m").reduced(), d_model=64,
                          num_heads=2, num_kv_heads=2, head_dim=32,
                          name="xlstm-micro")
CLUSTER = ClusterSpec(nodes=1, gpus_per_node=1, restart_cost_s=0.5)
STEPS = 40    # faults below strike on the first checkpoint at step 5
              # (WorkerFault.min_step), mid-run at this budget


def mk_jobs(n_jobs=1, steps=STEPS, gpus=1):
    jobs = [Job(f"j{i}", CFG, 2, 32, total_steps=steps, lr=1e-3, seed=i)
            for i in range(n_jobs)]
    profiles = {(j.name, "ddp", gpus): Profile(j.name, "ddp", gpus, 0.01,
                                               1e9, True, "t")
                for j in jobs}
    return jobs, profiles


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here, so in every child launched from here
    and in the LocalTorchBackend worker thread alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def backend(ckpt_dir, devices=("cpu",), **kw):
    return ProcessTorchBackend(ckpt_dir=str(ckpt_dir), devices=list(devices),
                               **kw)


def run(be, jobs, profiles, cluster=CLUSTER, **kw):
    try:
        return simulate(jobs, CurrentPractice(), profiles, cluster,
                        exec_backend=be, **kw)
    finally:
        be.shutdown()


def trajectory(res, name):
    """Absolute step -> loss, last write wins: steps replayed after a
    salvage overwrite their pre-crash records, leaving the trajectory
    training actually converged on."""
    d = {}
    for s, v in res.stats[name]["losses"]:
        d[s] = v
    return d


def sigkill_at_first_checkpoint():
    return ChaosTrace((WorkerFault(1.0, "sigkill", "j0", min_step=5),))


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """One uninterrupted run: the reference loss trajectory every
    recovery below must reproduce exactly."""
    jobs, profiles = mk_jobs()
    res = run(backend(tmp_path_factory.mktemp("base"), ckpt_every_steps=5),
              jobs, profiles)
    assert res.worker_failures == 0 and res.quarantined == {}
    return trajectory(res, "j0")


def test_process_backend_trains_for_real(tmp_path):
    """Two jobs really train in separate OS processes through the
    Schedule IR: exact step budgets, real finite losses, checkpoints on
    disk, measured step times in the feedback channel, and the
    supervision timings beside each segment."""
    jobs, profiles = mk_jobs(n_jobs=2, steps=20)
    be = backend(tmp_path)
    res = run(be, jobs, profiles)
    assert res.worker_failures == 0 and res.quarantined == {}
    for j in jobs:
        st = res.stats[j.name]
        assert sum(s["steps"] for s in st["segments"]) == j.total_steps
        assert len(st["losses"]) == j.total_steps
        assert all(np.isfinite(v) for _, v in st["losses"])
        assert verify_checkpoint(str(tmp_path / f"{j.name}.npz"))["step"] \
            == j.total_steps
        for seg in st["segments"]:
            assert seg["hello_s"] > 0 and seg["max_hb_gap_s"] > 0
    assert be.observed
    for v in be.observed.values():
        assert 0 < v < 10


@pytest.mark.parametrize("kind", ["sigkill", "hang", "corrupt"])
def test_fault_recovery_matches_baseline_bit_for_bit(kind, tmp_path,
                                                     baseline):
    """Inject a real fault mid-run; the supervisor must detect it
    (process sentinel / heartbeat deadline / checksum), salvage the
    durable checkpoint, relaunch under backoff, and land the EXACT
    uninterrupted loss trajectory."""
    jobs, profiles = mk_jobs()
    res = run(backend(tmp_path, ckpt_every_steps=5), jobs, profiles,
              chaos=ChaosTrace((WorkerFault(1.0, kind, "j0", min_step=5),)))
    assert res.worker_failures >= 1
    assert res.restarts >= 1
    assert res.quarantined == {}
    segs = res.stats["j0"]["segments"]
    assert len(segs) >= 2 and segs[0]["failed"]
    # the relaunch resumed from the durable checkpoint, not step 0 and
    # not the victim's in-memory progress
    assert segs[-1]["start_step"] + segs[-1]["steps"] == STEPS
    got = trajectory(res, "j0")
    assert set(got) == set(baseline)
    assert max(abs(got[s] - baseline[s]) for s in baseline) == 0.0


def test_budget_exhaustion_quarantines(tmp_path):
    """With a zero retry budget the first SIGKILL quarantines the job:
    the run completes (no deadlock, no raise) with the reason recorded
    and the durable progress preserved on disk."""
    jobs, profiles = mk_jobs()
    res = run(backend(tmp_path, ckpt_every_steps=5,
                      retry_policy=RetryPolicy(budget=0)),
              jobs, profiles, chaos=sigkill_at_first_checkpoint())
    assert res.worker_failures == 1
    assert "j0" in res.quarantined
    assert "retry budget exhausted" in res.quarantined["j0"]
    assert "SIGKILL" in res.quarantined["j0"]
    seg = res.stats["j0"]["segments"][0]
    assert seg["failed"] and seg["steps"] < STEPS


def test_crash_then_resume_across_backends(tmp_path, baseline):
    """A run killed mid-flight leaves a durable checkpoint; a fresh
    backend with resume=True continues from exactly that step and the
    union of both trajectories is the uninterrupted one, bit for bit."""
    jobs, profiles = mk_jobs()
    r1 = run(backend(tmp_path, ckpt_every_steps=5,
                     retry_policy=RetryPolicy(budget=0)),
             jobs, profiles, chaos=sigkill_at_first_checkpoint())
    assert "j0" in r1.quarantined
    durable = int(verify_checkpoint(str(tmp_path / "j0.npz"))["step"])
    assert 0 < durable < STEPS

    r2 = run(backend(tmp_path, ckpt_every_steps=5, resume=True), jobs,
             profiles)
    assert r2.worker_failures == 0 and r2.quarantined == {}
    segs = r2.stats["j0"]["segments"]
    assert segs[0]["start_step"] == durable
    assert sum(s["steps"] for s in segs) == STEPS - durable

    merged = trajectory(r1, "j0")
    merged.update(trajectory(r2, "j0"))
    assert set(merged) == set(baseline)
    assert max(abs(merged[s] - baseline[s]) for s in baseline) == 0.0


def test_process_trajectory_equals_local_backend(tmp_path, baseline):
    """The same job through LocalTorchBackend's worker thread, on one
    intra-op thread as the children run: the same losses, bit for bit."""
    jobs, profiles = mk_jobs()
    be = LocalTorchBackend(ckpt_dir=str(tmp_path), devices=["cpu"])
    res = simulate(jobs, CurrentPractice(), profiles, CLUSTER,
                   exec_backend=be)
    assert res.worker_failures == 0
    assert trajectory(res, "j0") == baseline


def test_two_device_placement_fails_in_the_child(tmp_path):
    """ddp x2 of a job whose batch of 3 does not split over its two
    ranks: the children raise, the coordinator gets a rank's error
    message as one worker failure of the job, retries under its budget,
    then quarantines the job; no rank outlives it."""
    jobs = [Job("j0", CFG, 3, 32, total_steps=10, lr=1e-3, seed=0)]
    profiles = {("j0", "ddp", 2): Profile("j0", "ddp", 2, 0.01, 1e9, True,
                                          "t")}
    res = run(backend(tmp_path, devices=["cpu", "cpu"],
                      retry_policy=RetryPolicy(budget=1, base_s=0.1,
                                               cap_s=0.2, jitter=0.0)),
              jobs, profiles, cluster=CLUSTER2)
    assert res.worker_failures == 2
    reason = res.quarantined["j0"]
    assert "retry budget exhausted" in reason
    assert "ValueError: a dim of 3 does not split over 2 ranks" in reason
    assert no_worker_left()


CLUSTER2 = ClusterSpec(nodes=1, gpus_per_node=2, restart_cost_s=0.1)
GROUP_STEPS = 20
LOSS_RTOL = 1e-5      # the loss bound of tests/test_torch_parallelism.py


def no_worker_left():
    return not [p for p in multiprocessing.active_children()
                if p.name.startswith("saturn-proc-")]


def run_two_ranks(tmp_path, chaos=None):
    jobs, profiles = mk_jobs(steps=GROUP_STEPS, gpus=2)
    res = run(backend(tmp_path, devices=["cpu", "cpu"], ckpt_every_steps=5),
              jobs, profiles, cluster=CLUSTER2, chaos=chaos)
    assert no_worker_left()
    return res


@pytest.fixture(scope="module")
def two_rank_baseline(tmp_path_factory):
    """ddp x2, uninterrupted: the trajectory the recoveries below must
    land on."""
    res = run_two_ranks(tmp_path_factory.mktemp("base2"))
    assert res.worker_failures == 0 and res.quarantined == {}
    segs = res.stats["j0"]["segments"]
    assert [(s["n_gpus"], s["ranks"]) for s in segs] == [(2, 2)]
    return trajectory(res, "j0")


def test_two_device_job_trains_in_a_group(two_rank_baseline, tmp_path):
    """ddp x2 on two CPU "devices": every rank in one gloo group, each on
    its half of the batch; the losses are those of ddp x1 (the same job
    in a LocalTorchBackend thread, which a one-rank child equals bit for
    bit) within the parity bound."""
    jobs, profiles = mk_jobs(steps=GROUP_STEPS)
    one = trajectory(simulate(jobs, CurrentPractice(), profiles, CLUSTER,
                              exec_backend=LocalTorchBackend(
                                  ckpt_dir=str(tmp_path), devices=["cpu"])),
                     "j0")
    assert sorted(two_rank_baseline) == sorted(one) \
        == list(range(1, GROUP_STEPS + 1))
    for s, v in two_rank_baseline.items():
        assert abs(v - one[s]) <= LOSS_RTOL * abs(one[s]), s


@pytest.mark.parametrize("kind", ["sigkill", "hang"])
def test_rank_one_fault_recovers_the_group(kind, tmp_path,
                                           two_rank_baseline):
    """A fault in rank 1, not rank 0: a SIGKILL (its sentinel) or a hang
    (its own heartbeat deadline, while rank 0 waits in a collective)
    fails the whole group once; the coordinator kills rank 0, salvages
    the durable checkpoint and relaunches both ranks, which land the
    uninterrupted trajectory exactly."""
    res = run_two_ranks(tmp_path, ChaosTrace(
        (WorkerFault(1.0, kind, "j0", min_step=5, rank=1),)))
    assert res.worker_failures == 1 and res.restarts >= 1
    assert res.quarantined == {}
    segs = res.stats["j0"]["segments"]
    assert segs[0]["failed"].startswith("rank 1: ")
    assert segs[-1]["start_step"] >= 5
    assert segs[-1]["start_step"] + segs[-1]["steps"] == GROUP_STEPS
    got = trajectory(res, "j0")
    assert set(got) == set(two_rank_baseline)
    assert max(abs(got[s] - two_rank_baseline[s])
               for s in two_rank_baseline) == 0.0


def test_session_runs_a_two_device_job_as_a_group(tmp_path):
    """SaturnSession.run(backend="process") on two CPU "devices": with
    profiles in which ddp x2 halves the step, the solver places the job
    on both devices, and it trains as a gloo group of two spawned
    ranks; no rank outlives the run."""
    sess = SaturnSession(CLUSTER2, library=ParallelismLibrary([DDP()]),
                         device="cpu")
    sess.submit([Job("j0", CFG, 2, 32, total_steps=10, lr=1e-3, seed=0)])
    sess.profiles = {("j0", "ddp", g): Profile("j0", "ddp", g, 0.02 / g,
                                               1e9, True, "t")
                     for g in (1, 2)}
    res = sess.run(backend="process", ckpt_dir=str(tmp_path),
                   time_limit_s=5)
    assert res.worker_failures == 0 and res.quarantined == {}
    segs = res.stats["j0"]["segments"]
    assert [(s["n_gpus"], s["ranks"]) for s in segs] == [(2, 2)]
    assert sorted(trajectory(res, "j0")) == list(range(1, 11))
    assert no_worker_left()


def test_two_device_empirical_trials_run_in_groups():
    """The Trial Runner's g = 2 trials: fsdp x2 and tp x2 on xlstm-micro
    in spawned groups of two gloo ranks, the slowest rank's step time;
    no peak memory is recorded on the CPU."""
    runner = TrialRunner(ParallelismLibrary(), HARDWARE["a100"],
                         device="cpu", devices=["cpu", "cpu"])
    job = Job("probe", CFG, 2, 32, total_steps=1)
    for tech in ("fsdp", "tp"):
        p = runner.profile(job, tech, 2, mode="empirical")
        assert p.feasible and p.source == "empirical", tech
        assert 0 < p.step_time_s < 30 and p.terms == {}
    assert no_worker_left()


class _FakeProcess:
    def __init__(self):
        self.killed = False

    def is_alive(self):
        return not self.killed

    def kill(self):
        self.killed = True


def test_a_group_without_step_progress_is_killed():
    """Both ranks heartbeat on time, as a rank blocked in a collective
    behind a wedged peer does from its sidecar thread, but no step lands
    within the progress deadline: the coordinator kills every rank."""
    be = ProcessTorchBackend()
    be.progress_timeout_s = 1.0
    be._lock = threading.Lock()
    now = time.monotonic()
    ranks = [_Rank(i, _FakeProcess(), None, now) for i in range(2)]
    p = _Proc(ranks, "", now - 10.0)
    for r in ranks:
        p.note_heartbeat(r, 3)
    p.started = True
    be._by_worker = {p: None}
    be._check_heartbeats()
    assert not any(r.process.killed for r in ranks)    # steps just landed
    p.last_progress_clock = time.monotonic() - 2.0
    be._check_heartbeats()
    assert all(r.process.killed for r in ranks)
    assert p.fail_hint == "no step progress in 1.0s"


def test_child_steps_while_the_parent_searches(tmp_path):
    """About a second of LNS search in the parent's interpreter does not
    stall a worker process: it keeps stepping (ROADMAP C4 on the CPU)."""
    job = Job("w", CFG, 2, 32, total_steps=10 ** 6, lr=1e-3, seed=0)
    be = backend(tmp_path)
    be.bind([job], {}, ClusterSpec(nodes=1, gpus_per_node=1))
    h = be.launch(job, ScheduleEntry("w", "ddp", 1), Placement((0,)),
                  "default", job.total_steps, 0.0, 0)
    p = h.worker
    try:
        deadline = time.monotonic() + 120
        while p.hb_steps < 2 and time.monotonic() < deadline:
            assert not p.done.is_set(), p.error_reason
            time.sleep(0.05)
        rng = np.random.RandomState(0)
        jobs, cm = [], {}
        for i in range(32):
            j = Job(f"j{i}", CFG, 8, 64, int(rng.randint(150, 500)))
            jobs.append(j)
            base, eff = rng.uniform(1.0, 4.0), rng.uniform(0.5, 0.95)
            cm[j.name] = [Choice("ddp", g, base * j.total_steps / g ** eff)
                          for g in (1, 2, 4, 8, 16, 32, 64)]
        steps0, t0 = p.hb_steps, time.perf_counter()
        lns_solve(jobs, cm, {None: 64}, deadline_s=1.0, seed=0)
        searched_s = time.perf_counter() - t0
        # heartbeats lag the child by up to one interval at either end
        during = p.hb_steps - steps0
    finally:
        done = be.preempt(h, be.now())
        be.shutdown()
    assert searched_s >= 0.9
    assert during >= 1
    assert done >= 2 and p.preempted
    assert os.path.exists(tmp_path / "w.npz")
