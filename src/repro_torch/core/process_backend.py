"""ProcessTorchBackend — supervised multi-process execution (fault
tolerance for real).

Third implementation of the engine's
:class:`~repro_torch.core.runtime.ExecutionBackend` protocol: like
:class:`~repro_torch.core.local_backend.LocalTorchBackend` every launch
REALLY trains, but each job segment runs in its own OS process,
supervised by this coordinator over a duplex pipe speaking the
:mod:`repro_torch.train.process_worker` protocol (hello / heartbeat-
with-step-counter / checkpoint-ack / exit).  That isolation is what
makes worker death survivable — and injectable:

- a worker process that EXITS without a clean ``exit`` message (crash,
  SIGKILL, OOM-kill) is detected through its process sentinel;
- a worker that goes SILENT past the heartbeat deadline (wedged in a
  syscall, livelocked) is detected through missed heartbeats and
  killed;
- both are surfaced to the engine through ``drain_failures`` as
  synthesized :class:`~repro_torch.core.chaos.WorkerFailure` events,
  which route into checkpoint salvage at the last DURABLE step,
  relaunch under the :class:`~repro_torch.core.chaos.RetryPolicy`'s
  exponential backoff + jitter, and quarantine once the retry budget is
  exhausted.

Each worker also has an interpreter of its own: an eager PyTorch step
takes the GIL back for every launch, so worker threads in one process
stall behind any thread that computes in Python (the solver of a
replan); worker processes do not.

The durable checkpoint chain (atomic, checksummed, ``.prev``
last-known-good — :mod:`repro_torch.checkpoint.store`) is the single
source of truth for recovery: ``salvage`` answers from the files a
relaunch will actually load, and a relaunched worker's ``hello``
carries the absolute step it REALLY resumed from, against which the
coordinator reconciles its own step accounting (``offset``) — so a kill
landing between a checkpoint commit and its ack, or a corrupt-file
fallback to ``.prev``, never desynchronizes the engine from the worker.

A dedicated monitor thread owns ALL pipe reads (the engine thread only
sends), waiting on connections and process sentinels together; the
engine's ``wait_until`` sleep is poked on every completion AND every
failure, so the scheduler never sleeps on an event that will not come.

Process groups: a launch on g devices is g children, one a device of
the placement, which join one process group (a ``FileStore`` in the
checkpoint directory, fresh for every launch; NCCL on cards, gloo on
the CPU) and run the technique's ``BuiltJob`` as its ranks.  A launch
on one device is a group of one rank.  The launch is alive only while
every rank is: one rank's death, or its silence past the heartbeat
deadline, gets the other ranks killed and surfaces as ONE failure of
the job, salvaged from the durable chain as for one process.  Each
rank heartbeats from its own sidecar thread, so a rank blocked in a
collective behind a wedged peer still heartbeats; the launch's step
progress has a deadline of its own (``PROGRESS_TIMEOUT_S``).

Devices: placement ids map through the backend's device list as in
``LocalTorchBackend`` (several ids may name the same card, which NCCL
refuses for two ranks of one group), and rank r is handed device r of
the placement in its spec (``"cuda:i"`` in the parent's own
visible-device frame, or ``"cpu"``); the parent builds and allocates
nothing.  Children start with ``spawn``: the parent may hold a CUDA
context, which a forked child cannot use.

Fault injection (:meth:`inject_fault`, driven by seeded
:class:`~repro_torch.core.chaos.WorkerFault` events) really hurts live
workers — SIGKILL mid-step, command a heartbeat stall, truncate the
checkpoint file on disk — and never shortcuts detection: recovery is
exercised end to end.
"""
from __future__ import annotations

import math
import multiprocessing
import os
import threading
import time
from multiprocessing import connection as mp_conn
from typing import Dict, List, Optional, Tuple

import torch

from ..parallelism.dist import file_store, remove_store
from ..train.process_worker import _worker_main
from .chaos import RetryPolicy, WorkerFault
from .job import ClusterSpec, Job
from .local_backend import LocalTorchBackend
from .runtime import LaunchHandle

# no step of a launch's group for this long while every rank heartbeats:
# a rank is stuck behind a peer (a full-width step plus a checkpoint
# commit takes seconds)
PROGRESS_TIMEOUT_S = 600.0


class _Rank:
    """One process of a launch's group: its pipe, its sentinel and its
    own heartbeat clock."""

    def __init__(self, index: int, process, conn, launched_clock: float):
        self.index = index
        self.process = process
        self.conn = conn
        self.conn_open = True
        self.ended = False          # its sentinel has fired
        self.clean_exit = False     # it sent its exit message
        self.got_hb = False
        self.last_hb_clock = launched_clock
        self.hb_steps = 0


class _Proc:
    """Coordinator-side record of one launch: the group of worker
    processes (one a device; rank 0 speaks the protocol), the
    supervision state the monitor thread maintains, plus a
    ``_Worker``-compatible stats surface (``steps_done`` /
    ``start_step`` / ``losses`` / ``measured_step_s`` / ``compile_s`` /
    ``preempted`` / ``finish_clock`` / ``done``) so the feedback and
    accounting plumbing inherited from :class:`LocalTorchBackend`
    applies as-is."""

    def __init__(self, ranks: List[_Rank], store: str,
                 launched_clock: float):
        self.ranks = ranks
        self.store = store
        self.dead_handled = False
        # supervision
        self.launched_clock = launched_clock
        self.got_hb = False
        self.last_hb_clock = launched_clock      # rank 0's
        self.hb_steps = 0                 # worker-frame step counter
        self.last_progress_clock = launched_clock
        self.started = False              # rank 0 said hello
        self._last_progress: Optional[Tuple[float, int]] = None
        self._hb_rate: Optional[float] = None
        self.fail_hint: Optional[str] = None     # set before a kill
        self.error_reason: Optional[str] = None  # a child's error message
        self.pending_fault: Optional[WorkerFault] = None
        # reconciliation: worker-frame steps + offset = engine frame
        self.offset = 0
        self.durable_abs: Optional[int] = None   # last checkpoint-ack
        # what a job pays to live in its own processes (seconds)
        self.hello_s: Optional[float] = None     # spawn -> hello
        self.max_hb_gap_s = 0.0
        self.commit_s: Optional[float] = None    # the last checkpoint
        # lifecycle / stats
        self.start_step = 0
        self.exit_msg: Optional[dict] = None
        self.preempted = False
        self.compile_s = 0.0
        self.losses: List[Tuple[int, float]] = []
        self.finish_clock: Optional[float] = None
        self.done = threading.Event()

    @property
    def process(self):
        """Rank 0's process."""
        return self.ranks[0].process

    def rank_note(self, rank: _Rank, what: str) -> str:
        return what if len(self.ranks) == 1 else f"rank {rank.index}: {what}"

    @property
    def raw_steps(self) -> int:
        """Steps this segment really ran (worker frame): what the stats
        surface records, so ``start_step + steps`` is the absolute step
        the segment reached even when resume pre-credited progress."""
        return self.exit_msg["steps"] if self.exit_msg is not None \
            else self.hb_steps

    @property
    def steps_done(self) -> int:
        # engine frame: the launch budget includes steps that were
        # already durable on disk at launch (resume), reconciled via
        # the hello offset
        return max(0, self.raw_steps + self.offset)

    @property
    def measured_step_s(self) -> Optional[float]:
        if self.exit_msg is not None and \
                self.exit_msg.get("measured_step_s"):
            return self.exit_msg["measured_step_s"]
        return self._hb_rate

    @property
    def segment_stats(self) -> dict:
        """Supervision timings recorded beside the segment's stats.
        ``commit_s`` is the last checkpoint's ack less the first
        heartbeat that reported its step: low by at most one heartbeat
        interval, and None where no heartbeat fell inside the commit."""
        return {"hello_s": self.hello_s, "max_hb_gap_s": self.max_hb_gap_s,
                "commit_s": self.commit_s, "ranks": len(self.ranks)}

    def note_heartbeat(self, rank: _Rank, steps: int) -> None:
        now = time.monotonic()
        rank.got_hb = True
        rank.last_hb_clock = now
        if steps > rank.hb_steps:
            rank.hb_steps = steps
            self.last_progress_clock = now
        if rank.index != 0:
            return
        if self.got_hb:
            self.max_hb_gap_s = max(self.max_hb_gap_s,
                                    now - self.last_hb_clock)
        self.got_hb = True
        self.last_hb_clock = now
        if steps > self.hb_steps:
            if self._last_progress is not None:
                dt = now - self._last_progress[0]
                ds = steps - self._last_progress[1]
                if dt > 0 and ds > 0:
                    r = dt / ds
                    self._hb_rate = r if self._hb_rate is None \
                        else 0.5 * self._hb_rate + 0.5 * r
            self._last_progress = (now, steps)
            self.hb_steps = steps


class ProcHandle(LaunchHandle):
    """LaunchHandle + the worker process executing it."""

    def __init__(self, proc: _Proc, *args):
        super().__init__(*args)
        self.worker = proc

    @property
    def finish_t(self) -> Optional[float]:
        return self.worker.finish_clock


class ProcessTorchBackend(LocalTorchBackend):
    """Execute schedules in supervised per-job worker processes."""

    kind = "process-torch"
    virtual = False
    exact_completions = False

    def __init__(self, library=None, ckpt_dir: Optional[str] = None,
                 devices: Optional[List] = None,
                 min_requeue_s: float = 0.25,
                 fallback_step_s: float = 0.1,
                 resume: bool = False,
                 retry_policy: Optional[RetryPolicy] = None,
                 ckpt_every_steps: int = 10,
                 heartbeat_every_s: float = 0.25,
                 heartbeat_timeout_s: float = 5.0,
                 startup_grace_s: float = 180.0,
                 preempt_timeout_s: float = 120.0):
        super().__init__(library=library, ckpt_dir=ckpt_dir,
                         devices=devices, min_requeue_s=min_requeue_s,
                         fallback_step_s=fallback_step_s, resume=resume,
                         retry_policy=retry_policy)
        self.ckpt_every_steps = int(ckpt_every_steps)
        self.heartbeat_every_s = float(heartbeat_every_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.preempt_timeout_s = float(preempt_timeout_s)
        self.progress_timeout_s = PROGRESS_TIMEOUT_S
        self._ctx = multiprocessing.get_context("spawn")
        self._monitor_thread: Optional[threading.Thread] = None
        # the backend whose run state (clock, handles, completion and
        # failure queues, stats, checkpoint directory) the launches
        # report to: this one, or the LocalTorchBackend it runs the
        # multi-device launches of (run_for)
        self._host: LocalTorchBackend = self

    # ------------------------------------------------------------- setup
    def bind(self, jobs, profiles, cluster: ClusterSpec) -> None:
        # the local backend's binding resolves the device list (raising
        # without a card) and builds nothing; children own the devices
        super().bind(jobs, profiles, cluster)
        self._start_supervision()

    def run_for(self, host: LocalTorchBackend) -> None:
        """Run the launches on more than one device of ``host``, a bound
        LocalTorchBackend: they report to its run state, so that the
        engine sees one backend, and this one starts supervising."""
        self._host = host
        self._start_supervision()

    def _start_supervision(self) -> None:
        self._shutdown = threading.Event()
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="saturn-proc-monitor")
        self._monitor_thread.start()

    def _procs(self) -> List[Tuple["_Proc", "ProcHandle"]]:
        """The live launches this backend supervises (a host
        LocalTorchBackend's thread launches share its table)."""
        with self._host._lock:
            return [(p, h) for p, h in self._host._by_worker.items()
                    if isinstance(p, _Proc)]

    def shutdown(self) -> None:
        """Stop supervision and kill any still-live workers (tests and
        explicit teardown; normal runs end with no workers left).  A
        backend that never bound has nothing to stop."""
        if self._monitor_thread is None:
            return
        self._shutdown.set()
        for p, _ in self._procs():
            self._release(p)
        self._monitor_thread.join()

    def _release(self, p: _Proc, timeout: float = 5.0) -> None:
        """Join every rank of a launch, killing any that outlive
        ``timeout``, and remove the group's store."""
        for r in p.ranks:
            r.process.join(timeout=timeout)
            if r.process.is_alive():
                r.process.kill()
                r.process.join(timeout=5.0)
        remove_store(p.store)

    def _kill(self, p: _Proc) -> None:
        for r in p.ranks:
            if r.process.is_alive():
                r.process.kill()

    # ------------------------------------------------------- supervision
    def _send(self, rank: _Rank, cmd: dict) -> None:
        try:
            rank.conn.send(cmd)
        except (BrokenPipeError, OSError):
            pass            # already dead; the sentinel will tell us

    def _handle_msg(self, p: _Proc, h: ProcHandle, rank: _Rank,
                    m: dict) -> None:
        kind = m.get("msg")
        if kind == "hello":
            # the durable checkpoint the child REALLY resumed from is
            # authoritative; reconcile the engine's step frame to it
            p.start_step = int(m["start_step"])
            p.offset = h.steps_at_start \
                - (h.job.total_steps - p.start_step)
            p.note_heartbeat(rank, 0)
            p.started = True
            p.last_progress_clock = p.last_hb_clock
            p.hello_s = p.last_hb_clock - p.launched_clock
        elif kind == "hb":
            p.note_heartbeat(rank, int(m["steps"]))
            # loss records stream with heartbeats so a killed segment
            # still leaves its trajectory behind
            p.losses.extend((int(s), float(v))
                            for s, v in m.get("losses", ()))
        elif kind == "ckpt":
            p.durable_abs = int(m["step"])
            p.note_heartbeat(rank, rank.hb_steps)  # a commit proves liveness
            p.last_progress_clock = p.last_hb_clock
            seen = p._last_progress
            p.commit_s = (p.last_hb_clock - seen[0]) if seen is not None \
                and p.start_step + seen[1] == p.durable_abs else None
            p.losses.extend((int(s), float(v))
                            for s, v in m.get("losses", ()))
            if p.pending_fault is not None \
                    and p.durable_abs >= p.pending_fault.min_step:
                fault, p.pending_fault = p.pending_fault, None
                self._apply_fault(p, h.job.name, fault)
        elif kind == "exit":
            rank.clean_exit = True
            if rank.index == 0:
                p.exit_msg = m
                p.preempted = bool(m.get("preempted"))
                p.compile_s = float(m.get("compile_s") or 0.0)
                p.losses = [(int(s), float(v))
                            for s, v in m.get("losses", [])]
                p.finish_clock = self._host.now()
                p.done.set()
        elif kind == "error":
            if p.error_reason is None:
                p.error_reason = p.rank_note(rank, m["reason"])

    def _drain_conn(self, p: _Proc, h: ProcHandle, rank: _Rank) -> None:
        try:
            while rank.conn_open and rank.conn.poll(0):
                self._handle_msg(p, h, rank, rank.conn.recv())
        except (EOFError, OSError):
            rank.conn_open = False

    def _on_rank_end(self, p: _Proc, h: ProcHandle, rank: _Rank) -> None:
        """A rank's process ended.  Rank 0 after its exit message ends the
        launch; another rank after its own exit message is simply done;
        any rank that ends otherwise fails the whole group (its peers
        would wait in their next collective), which is killed."""
        if rank.ended:
            return
        rank.ended = True
        # the pipe may still hold the child's last words (a final ckpt
        # ack, the exit payload, an error report): drain before judging
        self._drain_conn(p, h, rank)
        rank.conn_open = False
        if p.dead_handled:
            return
        if rank.clean_exit:
            if rank.index != 0:
                return
            failed = False
        else:
            failed = True
            if p.fail_hint is None and p.error_reason is None:
                p.error_reason = p.rank_note(
                    rank, f"worker process died without exit message "
                          f"(exit code {rank.process.exitcode})")
            self._kill(p)
        p.dead_handled = True
        if p.finish_clock is None:
            p.finish_clock = self._host.now()
        p.done.set()
        if not failed:
            if not p.preempted:
                with self._host._lock:
                    if p in self._host._by_worker:
                        self._host._finished.append(h)
            # preempted clean exits are consumed by preempt()
        else:
            reason = p.fail_hint or p.error_reason or "worker failed"
            with self._host._lock:
                # the engine already let go: stale
                if p in self._host._by_worker:
                    self._host._failed.append((h, reason))
        self._host._poke.set()

    def _check_heartbeats(self) -> None:
        """Every rank has its own heartbeat deadline, and the launch a
        deadline on step progress: a rank blocked in a collective behind
        a wedged peer keeps heartbeating from its sidecar thread, so
        only the steps show that the group is stuck."""
        now = time.monotonic()
        for p, h in self._procs():
            if p.dead_handled or p.done.is_set():
                continue
            for rank in p.ranks:
                if rank.ended or rank.clean_exit:
                    continue
                deadline = self.heartbeat_timeout_s if rank.got_hb \
                    else self.startup_grace_s
                if now - rank.last_hb_clock > deadline:
                    # a hung worker is killed and handled exactly like a
                    # dead one — _on_rank_end fires from the sentinel
                    p.fail_hint = p.rank_note(
                        rank, f"heartbeat deadline missed "
                              f"({deadline:.1f}s without heartbeat)")
                    self._kill(p)
                    break
            else:
                if p.started and now - p.last_progress_clock \
                        > self.progress_timeout_s:
                    p.fail_hint = (f"no step progress in "
                                   f"{self.progress_timeout_s:.1f}s")
                    self._kill(p)

    def _monitor(self) -> None:
        """The one thread that reads the pipes: worker messages, process
        sentinels, heartbeat deadlines."""
        while not self._shutdown.is_set():
            waitables = {}
            for p, h in self._procs():
                for rank in p.ranks:
                    if rank.ended:
                        continue
                    if rank.conn_open:
                        waitables[rank.conn] = (p, h, rank)
                    waitables[rank.process.sentinel] = (p, h, rank)
            if not waitables:
                self._shutdown.wait(0.05)
                continue
            try:
                ready = mp_conn.wait(list(waitables), timeout=0.2)
            except OSError:
                continue        # a sentinel closed under us; rescan
            for r in ready:
                p, h, rank = waitables[r]
                if r is rank.process.sentinel:
                    self._on_rank_end(p, h, rank)
                else:
                    self._drain_conn(p, h, rank)
            self._check_heartbeats()

    # ------------------------------------------------------ run lifecycle
    def _spec(self, job: Job, technique: str, devs, store: str) -> dict:
        """What every rank of a launch is told; each adds its rank and
        device."""
        return {
            "job_name": job.name,
            "model_cfg": job.cfg,
            "batch_size": job.batch_size,
            "seq_len": job.seq_len,
            "total_steps": job.total_steps,
            "lr": job.lr,
            "seed": job.seed,
            "technique": self.library.get(technique),
            "world_size": len(devs),
            "store": store,
            # a child on the CPU runs as many intra-op threads as this
            # process does now, so the two compute alike
            "cpu_threads": torch.get_num_threads(),
            "heartbeat_every_s": self.heartbeat_every_s,
        }

    def _spawn(self, spec: dict, devs, name: str) -> _Proc:
        """One child per device, rank r on ``devs[r]``."""
        ranks = []
        launched = time.monotonic()
        for r, dev in enumerate(devs):
            parent_conn, child_conn = self._ctx.Pipe(duplex=True)
            process = self._ctx.Process(
                target=_worker_main,
                args=(child_conn, dict(spec, rank=r, device=str(dev))),
                name=f"saturn-proc-{name}-r{r}", daemon=True)
            process.start()
            child_conn.close()      # the child holds its own end now
            ranks.append(_Rank(r, process, parent_conn, launched))
        return _Proc(ranks, spec["store"], launched)

    def launch(self, job: Job, entry, placement, device_class, remaining,
               t, token) -> ProcHandle:
        ckpt = os.path.join(self._host.ckpt_dir, f"{job.name}.npz")
        devs = [self._host._torch_devices[d] for d in placement.devices]
        spec = self._spec(job, entry.technique, devs,
                          file_store(self._host.ckpt_dir, job.name))
        spec.update(ckpt_path=ckpt, steps_to_run=int(remaining),
                    ckpt_every_steps=self.ckpt_every_steps)
        proc = self._spawn(spec, devs, job.name)
        try:
            est = self._host.est_step(job.name, entry.technique,
                                      entry.n_gpus, device_class)
        except KeyError:
            est = self.fallback_step_s
        if not math.isfinite(est) or est <= 0:
            est = self.fallback_step_s
        h = ProcHandle(proc, job, entry.technique, entry.n_gpus,
                       placement, t, est, remaining, token)
        with self._host._lock:
            self._host._by_worker[proc] = h
        return h

    def is_finished(self, handle: ProcHandle) -> bool:
        p = handle.worker
        return p.exit_msg is not None and not p.preempted

    def salvage(self, handle: ProcHandle) -> int:
        """A failed launch keeps exactly what recovery can load: the
        durable checkpoint chain on disk (current file, else the
        last-known-good ``.prev``), in the engine's step frame."""
        p = handle.worker
        self._kill(p)
        self._release(p)
        self._host._finish(handle, preempted=False,
                           error=(p.fail_hint or p.error_reason
                                  or "worker failed"))
        return self._host._durable_steps(handle)

    def preempt(self, handle: ProcHandle, t: float) -> int:
        p = handle.worker
        self._send(p.ranks[0], {"cmd": "stop"})
        if not p.done.wait(timeout=self.preempt_timeout_s):
            # checkpoint-and-exit never came back: treat as hung
            p.fail_hint = "no response to preemption"
            self._kill(p)
            p.done.wait(timeout=5.0)
        self._release(p)
        if p.exit_msg is not None:
            self._host._finish(handle, preempted=p.preempted)
            return p.steps_done
        # died instead of checkpointing: only the durable chain counts
        # (its failure record, if the monitor filed one, goes stale the
        # moment the engine drops this launch's token)
        self._host._finish(handle, preempted=False,
                           error=(p.fail_hint or p.error_reason
                                  or "died during preemption"))
        return self._host._durable_steps(handle)

    def complete(self, handle: ProcHandle, t: float) -> None:
        p = handle.worker
        # wait on the monitor (it owns the pipes): done fires once the
        # exit payload is consumed, or the death is handled
        p.done.wait(timeout=self.preempt_timeout_s)
        self._release(p, timeout=self.preempt_timeout_s)
        self._host._finish(handle, preempted=False)
        if p.exit_msg is None:
            raise RuntimeError(
                f"process launch of {handle.job.name} completed without "
                f"an exit message ({p.fail_hint or p.error_reason})")

    # --------------------------------------------------- fault injection
    def inject_fault(self, fault: WorkerFault,
                     running: Dict[str, LaunchHandle], t: float) -> None:
        if fault.kind not in ("sigkill", "hang", "corrupt"):
            raise ValueError(f"unknown worker-fault kind {fault.kind!r}")
        if fault.job is not None:
            h = running.get(fault.job)
            if h is None:
                return      # named victim not live; injection no-ops
            name = fault.job
        elif running:
            name = min(running)     # first live launch, deterministic
            h = running[name]
        else:
            return
        p = h.worker
        if not 0 <= fault.rank < len(p.ranks):
            raise ValueError(f"fault on rank {fault.rank} of {name}, which "
                             f"runs {len(p.ranks)} rank(s)")
        if fault.min_step > 0 and (p.durable_abs is None
                                   or p.durable_abs < fault.min_step):
            # worker startup wall time is load-dependent; hold the
            # strike until the durable chain reaches min_step (the
            # monitor applies it on the qualifying checkpoint-ack)
            p.pending_fault = fault
            return
        self._apply_fault(p, name, fault)

    def _apply_fault(self, p: _Proc, name: str,
                     fault: WorkerFault) -> None:
        victim = p.ranks[fault.rank]
        if fault.kind == "sigkill":
            p.fail_hint = p.rank_note(victim,
                                      "injected fault: SIGKILL mid-step")
            victim.process.kill()
        elif fault.kind == "hang":
            # the rank stops heartbeating AND progressing but stays
            # alive; detection must come from the heartbeat deadline
            self._send(victim, {"cmd": "hang"})
        elif fault.kind == "corrupt":
            p.fail_hint = p.rank_note(
                victim, "injected fault: checkpoint truncated + SIGKILL")
            ckpt = os.path.join(self._host.ckpt_dir, f"{name}.npz")
            if os.path.exists(ckpt):
                size = os.path.getsize(ckpt)
                with open(ckpt, "r+b") as f:
                    f.truncate(max(1, size // 2))
            victim.process.kill()
        else:
            raise ValueError(f"unknown worker-fault kind {fault.kind!r}")
