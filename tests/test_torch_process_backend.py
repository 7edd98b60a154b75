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
  LocalTorchBackend against the JAX package's local backend);
- a placement of two devices fails in the child with BuiltJob's message
  and the job is quarantined;
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
import os
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
from repro_torch.core.job import ClusterSpec, Job
from repro_torch.core.lns import lns_solve
from repro_torch.core.local_backend import LocalTorchBackend
from repro_torch.core.process_backend import ProcessTorchBackend
from repro_torch.core.profiler import Profile
from repro_torch.core.schedule import Placement, ScheduleEntry
from repro_torch.core.solver import Choice

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
    """ddp x2 reaches the child, where BuiltJob refuses a multi-device
    plan: the coordinator gets the child's error message as a worker
    failure, retries under its budget, then quarantines the job."""
    jobs, profiles = mk_jobs(steps=10, gpus=2)
    res = run(backend(tmp_path, devices=["cpu", "cpu"],
                      retry_policy=RetryPolicy(budget=1, base_s=0.1,
                                               cap_s=0.2, jitter=0.0)),
              jobs, profiles,
              cluster=ClusterSpec(nodes=1, gpus_per_node=2,
                                  restart_cost_s=0.1))
    assert res.worker_failures == 2
    reason = res.quarantined["j0"]
    assert "retry budget exhausted" in reason
    assert "NotImplementedError: ddp at 2 devices: multi-device execution " \
           "is not ported yet" in reason


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
