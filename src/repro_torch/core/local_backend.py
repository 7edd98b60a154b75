"""LocalTorchBackend — the Schedule IR drives REAL PyTorch training.

This is the second implementation of the engine's
:class:`~repro_torch.core.runtime.ExecutionBackend` protocol (the first
is the virtual-time :class:`~repro_torch.core.runtime.SimBackend`):
every launch starts an actual training loop for the job's model on the
placement's device slice, preemption really checkpoints
(:mod:`repro_torch.checkpoint.store`) and relaunch really resumes —
state AND data position — and measured per-step wall times feed back
into the profile view introspection replans plan over
(:class:`~repro_torch.core.perfmodel.ObservedProfiles`).  The engine
clock is the wall clock; completion events are *predictions* from the
profile estimates that the engine corrects against measured progress,
and worker threads interrupt the engine's sleep the moment a launch
really finishes.

Device mapping: the placement pools hand out global GPU ids
``0..total_gpus-1``; this backend maps them 1:1 onto ``devices``
(default: every card, ``cuda:0 … cuda:{n-1}``).  On the CPU, name the
CPU once per device the cluster should have
(``devices=["cpu", "cpu"]``), so that concurrent jobs train on
"disjoint" slices as they would on cards.

Eager PyTorch holds the GIL between the operations of a step, where a
compiled JAX step releases it for the whole step, so worker threads and
the engine thread (its sleeps, the solver of a replan) share one
interpreter more tightly than in the JAX package.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from .job import ClusterSpec, Job
from .library import ParallelismLibrary
from .perfmodel import ObservedProfiles, profile_key
from .runtime import ExecutionBackend, LaunchHandle


class _Worker(threading.Thread):
    """One launched job segment: a real training loop on a device slice.

    The engine-facing surface is tiny and lock-free (reads of ints and
    floats under the GIL): ``steps_done`` advances as steps retire,
    ``stop_flag`` requests a checkpoint-and-exit, ``done`` flips when
    the segment is over (naturally or preempted).  The first step after
    (re)launch is the warm-up (cuBLAS handles, the caching allocator's
    growth) and is timed separately — it must not poison the measured
    step rate (the profile-feedback channel).
    """

    def __init__(self, backend: "LocalTorchBackend", job: Job, technique,
                 devices: List, ckpt_path: str, steps_to_run: int):
        super().__init__(daemon=True,
                         name=f"saturn-local-{job.name}")
        self.backend = backend
        self.job = job
        self.technique = technique
        self.devices = devices
        self.ckpt_path = ckpt_path
        self.steps_to_run = int(steps_to_run)
        self.steps_done = 0
        self.start_step = 0            # absolute step resumed from
        self.stop_flag = threading.Event()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.preempted = False
        self.compile_s = 0.0
        self.finish_clock: Optional[float] = None
        self.losses: List[Tuple[int, float]] = []   # (absolute step, loss)
        self._dt_sum = 0.0
        self._dt_n = 0

    @property
    def measured_step_s(self) -> Optional[float]:
        """Mean post-warm-up step time; None until 2 steps retired."""
        if self._dt_n < 1:
            return None
        return self._dt_sum / self._dt_n

    def run(self) -> None:
        try:
            import torch
            dev = self.devices[0]
            # allocations and synchronizations of this thread hit its
            # own card
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._train()
        except BaseException as e:          # surfaced by the engine
            self.error = e
        finally:
            self.finish_clock = self.backend.now()
            self.done.set()
            self.backend._on_worker_done(self)

    def _train(self) -> None:
        from ..checkpoint.store import load_training_state, save_checkpoint
        from ..data.synthetic import SyntheticLM

        built = self.backend._built_job(self.job, self.technique,
                                        self.devices)
        params, opt = built.init(self.job.seed)
        params, opt, self.start_step = load_training_state(
            self.ckpt_path, params, opt)
        data = SyntheticLM(self.job.cfg, seed=self.job.seed).batches(
            self.job.batch_size, self.job.seq_len,
            num_batches=self.steps_to_run, skip=self.start_step,
            device=built.device)
        loss = float("nan")
        for b in data:
            if self.stop_flag.is_set():
                self.preempted = True
                break
            t0 = time.perf_counter()
            params, opt, m = built.step(params, opt, built.place_batch(b))
            # the loss's copy to the host waits for the whole step (the
            # update was queued before it on the same stream)
            loss = float(m.get("loss", float("nan")))
            dt = time.perf_counter() - t0
            if self.steps_done == 0:
                self.compile_s = dt
            else:
                self._dt_sum += dt
                self._dt_n += 1
            self.steps_done += 1
            self.losses.append((self.start_step + self.steps_done, loss))
        save_checkpoint(self.ckpt_path, {"params": params, "opt": opt},
                        {"step": self.start_step + self.steps_done,
                         "loss": loss})


class LocalHandle(LaunchHandle):
    """LaunchHandle + the worker thread executing it."""

    def __init__(self, worker: _Worker, *args):
        super().__init__(*args)
        self.worker = worker

    @property
    def finish_t(self) -> Optional[float]:
        return self.worker.finish_clock


class LocalTorchBackend(ExecutionBackend):
    """Execute schedules for real on this machine's devices."""

    kind = "local-torch"
    virtual = False
    exact_completions = False

    def __init__(self, library: Optional[ParallelismLibrary] = None,
                 ckpt_dir: Optional[str] = None,
                 devices: Optional[List] = None,
                 min_requeue_s: float = 0.25,
                 fallback_step_s: float = 0.1,
                 resume: bool = False,
                 retry_policy=None):
        self.library = library or ParallelismLibrary()
        # relaunch policy for failed workers (None: engine defaults)
        self.retry_policy = retry_policy
        self.ckpt_dir = ckpt_dir
        self._devices = devices
        self.min_requeue_s = min_requeue_s
        self.fallback_step_s = fallback_step_s
        # resume=False (default): a run starts its workload from step 0,
        # clearing this workload's checkpoints at bind time — WITHIN-run
        # preempt/relaunch still resumes.  resume=True continues from
        # whatever checkpoints ckpt_dir already holds (crash recovery).
        self.resume = resume
        self.observed: Dict[Tuple, float] = {}
        self.job_stats: Dict[str, dict] = {}
        self._built_cache: Dict[Tuple, object] = {}

    # ------------------------------------------------------------- setup
    def bind(self, jobs, profiles, cluster: ClusterSpec) -> None:
        from ..device import local_devices, resolve_device
        super().bind(jobs, profiles, cluster)
        self._torch_devices = (
            [resolve_device(d) for d in self._devices]
            if self._devices is not None else local_devices("cuda"))
        if cluster.total_gpus > len(self._torch_devices):
            raise RuntimeError(
                f"LocalTorchBackend: cluster asks for {cluster.total_gpus} "
                f"devices but only {len(self._torch_devices)} are given "
                f"({[str(d) for d in self._torch_devices]}); pass more "
                f"devices (or shrink the cluster)")
        if self.ckpt_dir is None:
            self.ckpt_dir = tempfile.mkdtemp(prefix="saturn_local_")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if not self.resume:
            # a stale checkpoint from a previous run would make a
            # "fresh" run silently continue a finished model
            for j in jobs:
                for suffix in (".npz", ".npz.prev", ".npz.meta.json"):
                    p = os.path.join(self.ckpt_dir, j.name + suffix)
                    if os.path.exists(p):
                        os.remove(p)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._poke = threading.Event()
        self._finished: List[LocalHandle] = []
        self._failed: List[Tuple[LocalHandle, str]] = []
        self._by_worker: Dict[_Worker, LocalHandle] = {}
        self.observed.clear()
        self.job_stats.clear()

    def _built_job(self, job: Job, technique, devices: List):
        """Build (or reuse) the executable for one (job, technique,
        device-slice) choice.  A job relaunched onto the SAME choice
        reuses its step; a changed assignment — the usual reason for a
        restart — builds a new one.  A plan the port does not run yet
        (more than one device, or tp / gpipe / fsdp) raises
        ``NotImplementedError`` here, in the worker: the engine records
        a worker failure and retries or quarantines the job."""
        from ..parallelism.build import BuiltJob
        key = (job.name, technique.name, tuple(str(d) for d in devices))
        with self._lock:
            built = self._built_cache.get(key)
        if built is None:
            plan = technique.plan(job.cfg, len(devices))
            built = BuiltJob(job.cfg, plan, job.opt_cfg, device=devices[0])
            with self._lock:
                self._built_cache[key] = built
        return built

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        return time.monotonic() - self._t0

    def event_time(self, ev) -> float:
        # real work may overrun its event's timestamp; the clock never
        # runs backwards
        return max(ev.t, self.now())

    def wait_until(self, t: float) -> None:
        # sleep until wall-clock t, but return the moment a launch
        # really finishes (its completion preempts the scheduled event);
        # spurious wake-ups loop — an event must never be processed
        # before its timestamp unless a real completion forces it
        while True:
            with self._lock:
                if self._finished or self._failed:
                    return
            dt = t - self.now()
            if dt <= 0:
                return
            self._poke.wait(timeout=dt)
            self._poke.clear()

    def _on_worker_done(self, worker: _Worker) -> None:
        # an exception escaping the worker goes to the FAILURE channel
        # (never _finished): the engine synthesizes a WorkerFailure,
        # salvages the durable checkpoint and retries/quarantines — the
        # scheduler is poked either way, so wait_until never sleeps on a
        # completion that will not come
        with self._lock:
            h = self._by_worker.get(worker)
            if h is not None and not worker.preempted:
                if worker.error is not None:
                    self._failed.append((h, f"worker thread died: "
                                         f"{type(worker.error).__name__}: "
                                         f"{worker.error}"))
                else:
                    self._finished.append(h)
        self._poke.set()

    def drain_finished(self) -> Tuple[LocalHandle, ...]:
        with self._lock:
            out, self._finished = tuple(self._finished), []
        return out

    def drain_failures(self) -> Tuple[Tuple[LocalHandle, str], ...]:
        with self._lock:
            out, self._failed = tuple(self._failed), []
        return out

    # ---------------------------------------------------------- feedback
    def _record(self, h: LocalHandle) -> None:
        m = h.worker.measured_step_s
        if m is None or not math.isfinite(m) or m <= 0:
            return
        key = profile_key(self._profiles, h.job.name, h.technique,
                          h.n_gpus, h.device_class)
        self.observed[key] = m

    def planning_profiles(self):
        """Measured step times overlaid on the estimates — what the
        introspection replans optimize over.  A fresh overlay per replan
        so the solver's choice cache (keyed on profile identity) never
        serves stale observations."""
        for h in list(self._by_worker.values()):
            self._record(h)
        if not self.observed:
            return self._profiles
        return ObservedProfiles(self._profiles, self.observed)

    def serve_step_time(self, serve, device_class=None) -> float:
        """REALLY measure a serving replica: run a saturated
        ContinuousBatchingEngine burst for this model (warm-up excluded)
        on the first device instead of reading the analytic serve
        profile.  Memoized per (model, device class, replica size) —
        fleets re-measure through replans, not per tick."""
        key = (serve.name, device_class, serve.gpus_per_replica)
        cache = getattr(self, "_serve_measured", None)
        if cache is None:
            cache = self._serve_measured = {}
        if key not in cache:
            from ..serving.profile import measure_serve_step_time
            cache[key] = measure_serve_step_time(
                serve.cfg, slots=min(serve.slots, 4), seed=0,
                device=self._torch_devices[0])
        return cache[key]

    # ------------------------------------------------------ run lifecycle
    def launch(self, job, entry, placement, device_class, remaining, t,
               token) -> LocalHandle:
        devs = [self._torch_devices[d] for d in placement.devices]
        ckpt = os.path.join(self.ckpt_dir, f"{job.name}.npz")
        worker = _Worker(self, job, self.library.get(entry.technique),
                         devs, ckpt, remaining)
        try:
            est = self.est_step(job.name, entry.technique, entry.n_gpus,
                                device_class)
        except KeyError:
            est = self.fallback_step_s
        if not math.isfinite(est) or est <= 0:
            est = self.fallback_step_s
        h = LocalHandle(worker, job, entry.technique, entry.n_gpus,
                        placement, t, est, remaining, token)
        with self._lock:
            self._by_worker[worker] = h
        worker.start()
        return h

    def eta(self, handle: LocalHandle) -> float:
        """Predicted completion: measured rate once observed, the
        profile estimate before that."""
        w = handle.worker
        if w.done.is_set():
            return w.finish_clock if w.finish_clock is not None \
                else self.now()
        rate = w.measured_step_s or handle.true_step_s
        left = max(0, handle.steps_at_start - w.steps_done)
        return max(self.now() + left * rate,
                   self.now() + self.min_requeue_s)

    def steps_done(self, handle: LocalHandle, upto_t: float) -> int:
        self._record(handle)
        return handle.worker.steps_done

    def is_finished(self, handle: LocalHandle) -> bool:
        return handle.worker.done.is_set()

    def _durable_steps(self, handle: LocalHandle) -> int:
        """Relative steps of this launch that are durably on disk —
        the checkpoint chain a relaunch will ACTUALLY load (current
        file, else last-known-good ``.prev``), measured against the
        absolute step the engine launched from.  This is what a failed
        launch salvages: nothing more than what recovery can resume."""
        from ..checkpoint.store import (CheckpointCorruptError,
                                        verify_checkpoint)
        ckpt = os.path.join(self.ckpt_dir, f"{handle.job.name}.npz")
        start_abs = handle.job.total_steps - handle.steps_at_start
        for p in (ckpt, ckpt + ".prev"):
            if not os.path.exists(p):
                continue
            try:
                meta = verify_checkpoint(p)
            except CheckpointCorruptError:
                continue
            return max(0, int(meta.get("step", 0)) - start_abs)
        return 0

    def salvage(self, handle: LocalHandle) -> int:
        w = handle.worker
        w.join()
        self._finish(handle, preempted=False,
                     error=(f"{type(w.error).__name__}: {w.error}"
                            if w.error is not None else "worker failed"))
        return self._durable_steps(handle)

    def preempt(self, handle: LocalHandle, t: float) -> int:
        """Checkpoint-and-stop, for real: the worker finishes its
        in-flight step, writes the checkpoint, and exits; relaunch
        resumes from it (the restart penalty the engine charges on top
        models the cluster's relaunch round-trip)."""
        w = handle.worker
        w.stop_flag.set()
        w.join()
        if w.error is not None:
            # the worker was already dead: report only the durable
            # progress a relaunch can really resume (its failure record
            # rides drain_failures, dropped as stale if this preemption
            # won the race) — never raise mid-replan
            self._finish(handle, preempted=False,
                         error=f"{type(w.error).__name__}: {w.error}")
            return self._durable_steps(handle)
        # w.preempted reflects what really happened: False if the
        # worker had already finished its budget before the stop landed
        self._finish(handle, preempted=w.preempted)
        return w.steps_done

    def complete(self, handle: LocalHandle, t: float) -> None:
        w = handle.worker
        w.join()
        self._finish(handle, preempted=False)
        if w.error is not None:
            raise RuntimeError(
                f"local launch of {handle.job.name} failed") from w.error

    def _finish(self, handle: LocalHandle, preempted: bool,
                error: Optional[str] = None) -> None:
        w = handle.worker
        self._record(handle)
        with self._lock:
            if self._by_worker.pop(w, None) is None and \
                    handle.job.name in self.job_stats:
                return    # already recorded (preempt/salvage race)
        seg = {
            "technique": handle.technique,
            "n_gpus": handle.n_gpus,
            "device_class": handle.device_class,
            # worker frame: start_step + steps = absolute step reached
            # (steps_done may additionally carry a resume pre-credit in
            # the engine frame)
            "start_step": w.start_step,
            "steps": getattr(w, "raw_steps", w.steps_done),
            "preempted": preempted,
            "failed": error,
            "compile_s": w.compile_s,
            "measured_step_s": w.measured_step_s,
            "first_loss": w.losses[0][1] if w.losses else None,
            "last_loss": w.losses[-1][1] if w.losses else None,
        }
        st = self.job_stats.setdefault(
            handle.job.name, {"segments": [], "losses": []})
        st["segments"].append(seg)
        st["losses"].extend(w.losses)

    def result_stats(self) -> Dict[str, dict]:
        return self.job_stats
