"""The Trial Runner (paper §2): profiles every ⟨model, parallelism,
GPU-count⟩ combination the Solver may choose.

Three interchangeable backends share one cache and result type:

- **empirical** — run real minibatches of the job's step and time them
  (exactly the paper's mechanism: one warm-up step, then two timed
  steps, with the device synchronized before each clock read).  It needs
  the device count to be available locally: the runner's device list
  (every card for ``device="cuda"``; ``devices=`` names them outright).
  A trial on g > 1 devices runs the same trial in a spawned process
  group of g ranks (``parallelism.dist.spawn``): the slowest rank's
  step and the largest peak memory over the ranks.
- **analytic** — one traced step on meta tensors
  (:mod:`repro_torch.launch.step_analysis`, the counterpart of the JAX
  package's compiled-HLO analysis), whose loop-aware flops, bytes and
  collective payloads give a three-term roofline time (compute / memory
  / collectives) against the target hardware's constants, and whose
  peak of live bytes is the memory a device needs.  It needs no card:
  a fake process group stands in for the other ranks, so every count
  is analysed as one rank of its own group.
- **napkin** — a closed-form roofline (no step is run), the cheap
  deterministic backend for benchmarks and the performance-model
  layer's synthetic sweeps.

``profile_all`` supports three strategies (paper §2's <5% overhead
budget): ``"exhaustive"`` runs a real trial for every valid combo and
returns the legacy dict; ``"interpolate"`` runs trials only at a
geometric subset of counts per ⟨job, technique⟩ and returns a
:class:`~repro_torch.core.perfmodel.PerfModel` of fitted throughput
curves; ``"roofline"`` analyses each ⟨job shape, technique, count⟩
ONCE, converts the op counts into a three-term roofline (compute / HBM
/ interconnect) whose per-device-class efficiency coefficients are
least-squares fit from a handful of real calibration trials, and
predicts every other combo.  The outstanding real trials land in a
versioned, atomically-written JSON cache (batched flushes: one rewrite
per ``flush_every`` new profiles, temp-file + ``os.replace`` so a crash
mid-write can never corrupt the cache); the roofline calibration
coefficients persist in the same file.  The cache's format is the JAX
package's, so either package reads the other's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import local_devices, resolve_device
from ..launch.step_analysis import (analyze_train_step, link_seconds,
                                    scale_analysis)
from ..models.params import param_count
from ..models.transformer import model_spec
from ..parallelism.base import Plan
from ..parallelism.build import BuiltJob
from ..parallelism.dist import spawn
from .job import DEFAULT_CLASS, Job
from .library import ParallelismLibrary


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float          # peak FLOP/s per device (bf16)
    hbm_bw: float         # bytes/s per device
    link_bw: float        # bytes/s per device interconnect
    hbm_capacity: float   # bytes per device


HARDWARE = {
    # TPU v5e (production dry-run target)
    "v5e": HardwareSpec("v5e", 197e12, 819e9, 50e9, 16e9),
    # A100-40GB (the paper's p4d.24xlarge nodes)
    "a100": HardwareSpec("a100", 312e12, 1555e9, 600e9 / 8, 40e9),
    # V100-16GB (p3.16xlarge) — the mixed-fleet second class
    "v100": HardwareSpec("v100", 125e12, 900e9, 300e9 / 8, 16e9),
}

# datasheet rates of the parts hardware_from_device knows, by the name
# torch.cuda.get_device_name reports: (dense bf16 FLOP/s, HBM bytes/s,
# link bytes/s — the NVLink aggregate over 8, as HARDWARE["a100"] takes
# it)
DATASHEET = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12, 900e9 / 8),
}


def hardware_for_class(base: HardwareSpec, device_class) -> HardwareSpec:
    """Derive a per-class HardwareSpec from the cluster's reference
    hardware and a :class:`~repro_torch.core.job.DeviceClass`: rates
    scale by ``speed_hint``; capacity comes from the class's HBM size."""
    s = float(device_class.speed_hint)
    return HardwareSpec(device_class.name, base.flops * s,
                        base.hbm_bw * s, base.link_bw * s,
                        device_class.hbm_per_gpu)


def hardware_from_device(device="cuda") -> HardwareSpec:
    """The spec of a local card: its name and memory from
    ``torch.cuda.get_device_properties``, its peak rates from the part's
    datasheet (:data:`DATASHEET`).  A part the datasheet table does not
    know raises: a guessed rate would mislead every napkin profile."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"hardware_from_device needs a CUDA device, "
                         f"got {str(dev)!r}")
    props = torch.cuda.get_device_properties(dev)
    try:
        flops, hbm_bw, link_bw = DATASHEET[props.name]
    except KeyError:
        raise ValueError(
            f"no datasheet rates for {props.name!r}; add the part to "
            f"DATASHEET (known: {sorted(DATASHEET)})") from None
    return HardwareSpec(props.name, flops, hbm_bw, link_bw,
                        float(props.total_memory))


@dataclasses.dataclass
class Profile:
    job: str
    technique: str
    n_devices: int
    step_time_s: float
    mem_per_device: float
    feasible: bool
    source: str
    terms: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_class: str = DEFAULT_CLASS

    def to_json(self):
        return dataclasses.asdict(self)


# v4: the cache also persists per-class roofline calibration fits —
# older caches (v3 and before) are discarded on load, not migrated: a
# v3 cache has no calibration section and re-running the trials is
# cheaper than guessing one
CACHE_VERSION = 4
PROFILE_MODES = ("analytic", "empirical", "napkin")
# a g > 1 empirical trial: spawn, group set-up and three steps
GROUP_TRIAL_TIMEOUT_S = 600.0
PROFILE_STRATEGIES = ("exhaustive", "interpolate", "roofline")


def timed_trial(built: BuiltJob, batch_size: int, seq_len: int):
    """One warm-up and two timed minibatches of ``built``'s step, per
    the paper: (mean seconds a step, peak bytes allocated on a card, or
    None on the CPU).  The trial's state is freed before it returns."""
    from ..configs import concrete_batch
    dev = built.device
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    if on_cuda:
        # the allocator's statistics exist once CUDA is initialised: in a
        # process whose first CUDA call this is, resetting them raises
        # ("Invalid device argument")
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
    params = opt = batch = None
    try:
        params, opt = built.init(0)
        batch = built.place_batch(concrete_batch(
            built.cfg, batch_size, seq_len, device=dev))
        params, opt, _ = built.step(params, opt, batch)
        sync()
        t0 = time.perf_counter()
        for _ in range(2):
            params, opt, _ = built.step(params, opt, batch)
        sync()
        dt = (time.perf_counter() - t0) / 2
        peak = float(torch.cuda.max_memory_allocated(dev)) if on_cuda \
            else None
    finally:
        # parameters, optimizer moments and the batch would otherwise
        # pile up across trials
        del params, opt, batch
        if on_cuda:
            torch.cuda.empty_cache()
    return dt, peak


def _group_trial(group, cfg, plan: Plan, opt_cfg, batch_size: int,
                 seq_len: int):
    """:func:`timed_trial` as one rank of a g > 1 trial: the largest
    step time and peak over the ranks."""
    import torch.distributed as dist
    built = BuiltJob(cfg, plan, opt_cfg, group=group)
    dt, peak = timed_trial(built, batch_size, seq_len)
    got = torch.tensor([dt, peak or 0.0], device=built.device)
    dist.all_reduce(got, op=dist.ReduceOp.MAX)
    return float(got[0]), float(got[1]) if peak is not None else None


@dataclasses.dataclass
class ClassCalibration:
    """Per-device-class roofline efficiency fit.

    ``coef`` scales the three raw roofline features — the dominant
    ``max(compute, HBM)`` term, the interconnect term, and the fixed
    per-step launch latency — so ``t = coef · features``.  With fewer
    than 4 calibration points the fit collapses to a single shared
    efficiency (``coef[0] == coef[1] == coef[2]``): a scalar is all the
    data can support, and it is exactly the "machine balance" knob the
    roofline literature calibrates.  ``residual`` is the relative RMS
    error on the calibration points themselves (used as a confidence
    signal, not a held-out estimate).
    """
    device_class: str
    coef: Tuple[float, float, float]
    n_points: int
    residual: float
    mode: str

    def predict(self, features) -> float:
        t = float(np.dot(np.asarray(self.coef), np.asarray(features)))
        return max(t, 1e-9)

    def to_json(self):
        d = dataclasses.asdict(self)
        d["coef"] = list(self.coef)
        return d

    @classmethod
    def from_json(cls, d) -> "ClassCalibration":
        d = dict(d)
        d["coef"] = tuple(float(c) for c in d["coef"])
        return cls(**d)


def fit_calibration(device_class: str, points, mode: str
                    ) -> ClassCalibration:
    """Least-squares fit of per-class efficiency coefficients over the
    calibration trials.  ``points`` is a sequence of
    ``(features, observed_step_s)`` with 3-vector features.

    >=4 points fit the full 3-coefficient model (falling back when the
    solution goes non-physical, i.e. a negative dominant coefficient);
    fewer points — the default ~2 real trials per class — fit the
    single shared efficiency ``a = Σ x·y / Σ x·x`` over the summed
    features.
    """
    A = np.asarray([f for f, _ in points], dtype=float)
    y = np.asarray([t for _, t in points], dtype=float)
    coef = None
    if len(points) >= 4:
        full, *_ = np.linalg.lstsq(A, y, rcond=None)
        if np.all(np.isfinite(full)) and full[0] > 0 and \
                full[1] >= 0 and full[2] >= 0:
            coef = tuple(float(c) for c in full)
    if coef is None:
        x = A.sum(axis=1)
        denom = float(np.dot(x, x))
        a = float(np.dot(x, y) / denom) if denom > 0 else 1.0
        a = a if math.isfinite(a) and a > 0 else 1.0
        coef = (a, a, a)
    pred = A @ np.asarray(coef)
    rel = np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)
    residual = float(np.sqrt(np.mean(rel ** 2))) if len(y) else math.inf
    return ClassCalibration(device_class, coef, len(points), residual,
                            mode)


class TrialRunner:
    """Profiles ⟨job, technique, count⟩ combos.  Empirical trials run on
    ``devices`` when given, else on the devices of ``device`` (every card
    for ``"cuda"``), resolved at the first empirical trial: without a
    card it raises there.  The analytic and napkin modes never need
    one."""

    def __init__(self, library: ParallelismLibrary,
                 hardware: HardwareSpec = HARDWARE["a100"],
                 cache_path: Optional[str] = None,
                 flush_every: int = 16,
                 hardware_by_class: Optional[Dict[str, HardwareSpec]] = None,
                 device="cuda", devices=None):
        self.library = library
        self.hw = hardware
        # per-device-class hardware: the reference spec under "default";
        # register_class / hardware_by_class add mixed-fleet entries
        self.hw_by_class: Dict[str, HardwareSpec] = {DEFAULT_CLASS: hardware}
        self.hw_by_class.update(hardware_by_class or {})
        self.cache_path = cache_path
        self.flush_every = max(1, flush_every)
        self.device = device
        self._devices = devices
        self.trials = 0            # real trials computed by THIS runner
        self._dirty = 0            # new profiles since the last flush
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, str, int, str, str], Profile] = {}
        # one BuiltJob per ⟨shape-identical job, technique, mesh shape,
        # device⟩: empirical trials of shape-identical jobs reuse it
        self._built_cache: Dict[Tuple, BuiltJob] = {}
        # one step analysis per ⟨shape-identical job, technique, mesh
        # shape⟩, shared by the analytic mode and the roofline strategy,
        # and the wall seconds each took
        self._analysis_cache: Dict[Tuple, Dict[str, float]] = {}
        self.analysis_wall_s: Dict[Tuple, float] = {}
        self._analysis_lock = threading.Lock()
        # per-device-class roofline calibration (persisted in the cache)
        self.calibration: Dict[str, ClassCalibration] = {}
        if cache_path and os.path.exists(cache_path):
            self._load_cache(cache_path)

    def _local_devices(self) -> List[torch.device]:
        """The devices empirical trials may use (raises without a card
        when left at ``device="cuda"``)."""
        if self._devices is not None:
            return [resolve_device(d) for d in self._devices]
        return local_devices(self.device)

    def register_class(self, device_class) -> HardwareSpec:
        """Register a :class:`~repro_torch.core.job.DeviceClass`,
        deriving its HardwareSpec from the reference hardware
        (idempotent; an explicit ``hardware_by_class`` entry wins)."""
        hw = self.hw_by_class.get(device_class.name)
        if hw is None:
            hw = hardware_for_class(self.hw, device_class)
            self.hw_by_class[device_class.name] = hw
        return hw

    def _class_hw(self, device_class: str) -> HardwareSpec:
        try:
            return self.hw_by_class[device_class]
        except KeyError:
            raise ValueError(
                f"unknown device class {device_class!r}; register it "
                f"(register_class / hardware_by_class); have "
                f"{list(self.hw_by_class)}") from None

    def _load_cache(self, path: str) -> None:
        """Versioned load: stale schemas (the legacy bare list, an older
        version number) and torn/corrupt files are silently discarded —
        a cache is a cache, never a crash."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            return
        if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
            return
        for rec in data.get("profiles", []):
            try:
                p = Profile(**rec)
            except TypeError:
                continue
            self._cache[(p.job, p.technique, p.n_devices, p.source,
                         p.device_class)] = p
        for dc, rec in (data.get("calibration") or {}).items():
            try:
                self.calibration[dc] = ClassCalibration.from_json(rec)
            except (TypeError, KeyError, ValueError):
                continue

    # ------------------------------------------------------------- public
    def profile(self, job: Job, technique: str, n_devices: int,
                mode: str = "analytic",
                device_class: str = DEFAULT_CLASS) -> Profile:
        if mode not in PROFILE_MODES:
            raise ValueError(f"unknown profiling mode {mode!r}; "
                             f"expected one of {PROFILE_MODES}")
        hw = self._class_hw(device_class)
        key = (job.name, technique, n_devices, mode, device_class)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        tech = self.library.get(technique)
        if not tech.search_space(job.cfg, n_devices):
            prof = Profile(job.name, technique, n_devices, float("inf"),
                           float("inf"), False, mode,
                           device_class=device_class)
            ran_trial = False
        else:
            if mode == "empirical":
                prof = self._profile_empirical(job, technique, n_devices,
                                               hw, device_class)
            elif mode == "napkin":
                prof = self._profile_napkin(job, technique, n_devices,
                                            hw, device_class)
            else:
                prof = self._profile_analytic(job, technique, n_devices,
                                              hw, device_class)
            ran_trial = True
        with self._lock:
            self._cache[key] = prof
            if ran_trial:
                self.trials += 1
            self._dirty += 1
            if self.cache_path and self._dirty >= self.flush_every:
                self._flush_locked()
        return prof

    def profile_all(self, jobs, gpu_counts, mode="analytic", *,
                    strategy: str = "exhaustive",
                    workers: Optional[int] = None,
                    anchor_ratio: float = 2.0,
                    classes=None,
                    calibration_trials: int = 2,
                    confidence_threshold: float = 0.3):
        """Profile a workload over ``gpu_counts``.

        ``strategy="exhaustive"`` runs a real trial at every valid
        (technique, count) and returns the legacy profile dict.

        ``strategy="interpolate"`` runs trials only at the geometric
        anchor subset per ⟨job, technique, device class⟩ (plus
        feasibility boundary counts) and returns a
        :class:`~repro_torch.core.perfmodel.PerfModel` whose curves
        evaluate every other count.

        ``strategy="roofline"`` runs only ``calibration_trials`` real
        trials per device class to fit that class's roofline efficiency
        coefficients (persisted in the profile cache, so a later run —
        or a new device class with a cached fit — runs NO trials at
        all), predicts every combo from the step analysis's op counts,
        and returns a :class:`~repro_torch.core.perfmodel.PerfModel`.
        Combos the prediction cannot be confident about — unfit
        collective kinds in the step, memory within a few percent of
        capacity, a poor calibration fit — fall back to real trials when
        their confidence drops below ``confidence_threshold`` (0
        disables the fallback, 1 escalates everything).

        ``classes`` (a sequence of
        :class:`~repro_torch.core.job.DeviceClass`) switches on
        heterogeneous profiling: every class gets its OWN anchor trials
        against its own hardware constants, counts are truncated to each
        class's capacity, and results are keyed
        ``(job, tech, device_class, g)`` (dict) / carry class-qualified
        curves (PerfModel).  Without it, the legacy single-class shapes
        are preserved exactly.
        """
        from .perfmodel import (PerfModel, ThroughputCurve,
                                select_anchor_counts)
        if strategy not in PROFILE_STRATEGIES:
            raise ValueError(
                f"unknown profiling strategy {strategy!r}; expected one "
                f"of {PROFILE_STRATEGIES}")
        counts = sorted(set(int(g) for g in gpu_counts))
        hetero = classes is not None
        if hetero:
            class_counts = {dc.name: [g for g in counts
                                      if g <= dc.total_gpus]
                            for dc in classes}
            for dc in classes:
                self.register_class(dc)
        else:
            class_counts = {DEFAULT_CLASS: counts}
        if strategy == "exhaustive":
            tasks = [(job, tech, g, dc)
                     for job in jobs for dc, cts in class_counts.items()
                     for tech, g in self.library.candidates(job.cfg, cts)]
            self._run_trials(tasks, mode, workers)
            self.flush()
            if hetero:
                return {(job.name, tech, dc, g):
                        self._cache[(job.name, tech, g, mode, dc)]
                        for job, tech, g, dc in tasks}
            return {(job.name, tech, g):
                    self._cache[(job.name, tech, g, mode, DEFAULT_CLASS)]
                    for job, tech, g, _ in tasks}
        if strategy == "roofline":
            return self._profile_all_roofline(
                jobs, counts, class_counts, mode, workers, hetero,
                calibration_trials, confidence_threshold)
        plan: Dict[Tuple[str, str, str], Tuple[Job, list, list]] = {}
        tasks = []
        for job in jobs:
            for dc, cts in class_counts.items():
                for tech_name, tech in self.library.items():
                    valid = [g for g in cts
                             if tech.search_space(job.cfg, g)]
                    if not valid:
                        continue
                    anchors = select_anchor_counts(valid, anchor_ratio)
                    plan[(job.name, tech_name, dc)] = (job, valid, anchors)
                    tasks.extend((job, tech_name, g, dc) for g in anchors)
        self._run_trials(tasks, mode, workers)
        self.flush()
        curves = {}
        for (jname, tech_name, dc), (job, valid, anchors) in plan.items():
            profs = {g: self._cache[(jname, tech_name, g, mode, dc)]
                     for g in anchors}
            curve = ThroughputCurve(
                jname, tech_name, self._class_hw(dc).hbm_capacity, profs,
                valid=valid, domain=class_counts[dc], device_class=dc)
            if hetero:
                curves[(jname, tech_name, dc)] = curve
            else:
                curves[(jname, tech_name)] = curve
        return PerfModel(curves, counts,
                         counts_by_class=class_counts if hetero else None)

    def _run_trials(self, tasks, mode: str, workers: Optional[int]) -> None:
        """Run the outstanding real trials, in parallel where safe.

        Empirical trials time real minibatches, so they must not share
        the machine — those always run serially.  Analytic and napkin
        trials fan out over a thread pool (step analyses take turns:
        ``step_analysis`` serialises them).
        """
        seen = set()
        todo = []
        for job, tech, g, dc in tasks:
            key = (job.name, tech, g, dc)
            if key in seen:
                continue
            seen.add(key)
            todo.append((job, tech, g, dc))
        if workers is None:
            workers = 1 if mode == "empirical" else \
                min(8, os.cpu_count() or 1)
        if workers <= 1 or len(todo) <= 1 or mode == "empirical":
            for job, tech, g, dc in todo:
                self.profile(job, tech, g, mode, device_class=dc)
            return
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(self.profile, job, tech, g, mode,
                                device_class=dc)
                    for job, tech, g, dc in todo]
            for f in futs:
                f.result()

    # ------------------------------------------------- roofline strategy
    def _calibration_combos(self, combos, k: int, mode: str,
                            local: Optional[int]):
        """Pick the ~k ⟨job, technique, count⟩ combos whose real trials
        anchor one class's calibration: round-robin over distinct
        (job, technique) pairs, alternating each pair's largest and
        smallest valid count so the fit sees both the collective-heavy
        and the single-device regime.  Empirical trials can only run on
        the ``local`` counts the runner's devices host."""
        picked, out = set(), []
        i = 0
        while len(out) < max(1, k) and i < 4 * max(1, len(combos)):
            job, tech_name, valid = combos[i % len(combos)]
            i += 1
            cts = [g for g in valid if g <= local] \
                if mode == "empirical" else valid
            if not cts:
                continue
            g = cts[-1] if len(out) % 2 == 0 else cts[0]
            key = (job.name, tech_name, g)
            if key in picked:
                continue
            picked.add(key)
            out.append((job, tech_name, g))
        return out

    def _profile_all_roofline(self, jobs, counts, class_counts, mode,
                              workers, hetero, calibration_trials,
                              confidence_threshold):
        from .perfmodel import PerfModel, ThroughputCurve
        # the counts an empirical trial can host, read once
        local = len(self._local_devices()) if mode == "empirical" else None
        plan: Dict[Tuple[str, str, str], Tuple[Job, list]] = {}
        by_class: Dict[str, list] = {}
        for job in jobs:
            for dc, cts in class_counts.items():
                for tech_name, tech in self.library.items():
                    valid = [g for g in cts
                             if tech.search_space(job.cfg, g)]
                    if not valid:
                        continue
                    plan[(job.name, tech_name, dc)] = (job, valid)
                    by_class.setdefault(dc, []).append(
                        (job, tech_name, valid))
        # ---- 1) per-class calibration: reuse a persisted fit when one
        # exists for this mode, otherwise run the calibration trials
        calib: Dict[str, list] = {}
        tasks = []
        for dc, combos in by_class.items():
            cached = self.calibration.get(dc)
            if cached is not None and cached.mode == mode and \
                    cached.n_points >= 1:
                continue
            calib[dc] = self._calibration_combos(
                combos, calibration_trials, mode, local)
            tasks.extend((job, tech_name, g, dc)
                         for job, tech_name, g in calib[dc])
        self._run_trials(tasks, mode, workers)
        for dc, picked in calib.items():
            hw = self._class_hw(dc)
            pts = []
            for job, tech_name, g in picked:
                p = self._cache[(job.name, tech_name, g, mode, dc)]
                if not (math.isfinite(p.step_time_s)
                        and p.step_time_s > 0):
                    continue
                tech_plan = self.library.get(tech_name).plan(job.cfg, g)
                feats, _, _ = self._raw_features(job, tech_plan, hw, mode)
                pts.append((feats, p.step_time_s))
            self.calibration[dc] = fit_calibration(dc, pts, mode) if pts \
                else ClassCalibration(dc, (1.0, 1.0, 1.0), 0,
                                      float("inf"), mode)
        # ---- 2) predict every combo; collect low-confidence escalations
        anchors: Dict[Tuple[str, str, str], Dict[int, Profile]] = {}
        escalate = []
        n_predicted = 0
        for (jname, tech_name, dc), (job, valid) in plan.items():
            hw = self._class_hw(dc)
            cal = self.calibration[dc]
            a: Dict[int, Profile] = {}
            for g in valid:
                real = self._cache.get((jname, tech_name, g, mode, dc))
                if real is not None:
                    a[g] = real
                    continue
                pred = self._predict_roofline(job, tech_name, g, hw, dc,
                                              cal, mode)
                hostable = mode != "empirical" or g <= local
                if pred.terms["confidence"] < confidence_threshold \
                        and hostable:
                    escalate.append((job, tech_name, g, dc))
                a[g] = pred
                n_predicted += 1
            anchors[(jname, tech_name, dc)] = a
        # ---- 3) escalated combos get REAL trials that replace their
        # predictions (and land in the persistent cache)
        self._run_trials(escalate, mode, workers)
        for job, tech_name, g, dc in escalate:
            anchors[(job.name, tech_name, dc)][g] = \
                self._cache[(job.name, tech_name, g, mode, dc)]
        self.roofline_stats = {
            "predicted": n_predicted - len(escalate),
            "escalated": len(escalate),
            "calibration_trials": sum(len(v) for v in calib.values()),
        }
        # predictions are cached too (source="roofline", so they can
        # never be mistaken for a real trial of any mode)
        with self._lock:
            for (jname, tech_name, dc), a in anchors.items():
                for g, p in a.items():
                    if p.source == "roofline":
                        self._cache[(jname, tech_name, g, "roofline",
                                     dc)] = p
                        self._dirty += 1
        self.flush()
        curves = {}
        for (jname, tech_name, dc), (job, valid) in plan.items():
            curve = ThroughputCurve(
                jname, tech_name, self._class_hw(dc).hbm_capacity,
                anchors[(jname, tech_name, dc)], valid=valid,
                domain=class_counts[dc], device_class=dc)
            if hetero:
                curves[(jname, tech_name, dc)] = curve
            else:
                curves[(jname, tech_name)] = curve
        return PerfModel(curves, counts,
                         counts_by_class=class_counts if hetero else None)

    # --------------------------------------------------------- empirical
    def _profile_empirical(self, job: Job, technique: str, n_devices: int,
                           hw: HardwareSpec, device_class: str) -> Profile:
        devices = self._local_devices()
        if n_devices > len(devices):
            raise RuntimeError(
                f"empirical profiling needs {n_devices} local devices")
        try:
            plan = self.library.get(technique).plan(job.cfg, n_devices)
            if n_devices > 1:
                # one spawned rank a device; the slowest rank's step and
                # the largest peak over the ranks
                dt, peak = spawn(
                    _group_trial, devices[:n_devices], job.cfg, plan,
                    job.opt_cfg, job.batch_size, job.seq_len,
                    timeout_s=GROUP_TRIAL_TIMEOUT_S)
            else:
                dt, peak = timed_trial(
                    self._built_job(job, plan, devices[:1]),
                    job.batch_size, job.seq_len)
        except (AssertionError, ValueError, TypeError, ZeroDivisionError,
                RuntimeError, TimeoutError) as e:
            # a trial that cannot even build/run its step for THIS
            # job's concrete shape is an infeasible choice, not a
            # crashed sweep — exactly what a real cluster trial would
            # conclude (a group's RuntimeError carries the failing
            # rank's traceback)
            print(f"trial {job.name}/{technique}x{n_devices} failed "
                  f"({e!r}); recording infeasible")
            return Profile(job.name, technique, n_devices, float("inf"),
                           float("inf"), False, "empirical",
                           {"trial_error": 1.0},
                           device_class=device_class)
        terms = {"peak_mem_bytes": peak} if peak is not None else {}
        mem = self._mem_estimate(job, plan)
        return Profile(job.name, technique, n_devices, dt, mem,
                       mem <= hw.hbm_capacity, "empirical", terms,
                       device_class=device_class)

    def _built_job(self, job: Job, plan: Plan, devices) -> BuiltJob:
        """Memoized BuiltJob per shape key and device — repeat empirical
        trials of shape-identical jobs reuse it."""
        key = self._shape_key(job, plan.technique, plan.mesh_shape) + \
            (str(devices[0]),)
        with self._lock:
            built = self._built_cache.get(key)
        if built is None:
            built = BuiltJob(job.cfg, plan, job.opt_cfg, device=devices[0])
            with self._lock:
                self._built_cache.setdefault(key, built)
        return built

    # ---------------------------------------------------------- analytic
    def _profile_analytic(self, job: Job, technique: str, n_devices: int,
                          hw: HardwareSpec, device_class: str) -> Profile:
        tech = self.library.get(technique)
        plan = tech.plan(job.cfg, n_devices)
        return self._finish(job, technique, n_devices,
                            self._roofline_from_analysis(job, plan, hw),
                            "analytic", hw, device_class)

    def _analysis(self, job: Job, plan: Plan) -> Dict[str, float]:
        """Memoized step analysis per ⟨job-shape, technique,
        mesh-shape⟩ (:func:`~repro_torch.launch.step_analysis.
        analyze_train_step` as rank 0, fp32 parameters and AdamW state,
        as the JAX package lowers its step), shared by the analytic
        mode and the roofline strategy.  Analyses take turns (they
        share the process's default group), so a trial thread that asks
        for a step another thread is analysing waits for its result."""
        key = self._shape_key(job, plan.technique, plan.mesh_shape)
        with self._analysis_lock:
            a = self._analysis_cache.get(key)
            if a is None:
                t0 = time.perf_counter()
                a = analyze_train_step(job.cfg, plan, job.opt_cfg,
                                       job.batch_size, job.seq_len)
                with self._lock:
                    self._analysis_cache[key] = a
                    self.analysis_wall_s[key] = time.perf_counter() - t0
        return a

    def _roofline_from_analysis(self, job: Job, plan: Plan,
                                hw: HardwareSpec) -> Dict[str, float]:
        """The analytic mode's terms (a step that cannot be analysed
        raises: a fake group hosts every count, so no combo needs the
        JAX package's napkin fallback).  The analysis counts one rank's
        step with every layer, every step of a recurrence and every
        remat recompute (the JAX package's ``cost_analysis()`` counts a
        scanned layer group once); the memory a device needs is the
        step's peak of live bytes."""
        a = self._analysis(job, plan)
        n = plan.n_devices
        link_s = link_seconds(a["collectives"], n, hw.link_bw)[0] \
            if n > 1 else 0.0
        return {
            "compute_s": a["flops"] / hw.flops,
            "memory_s": a["bytes_written"] / hw.hbm_bw,
            "collective_s": link_s,
            "hlo_flops": a["flops"] * n,
            "collective_bytes": a["collectives"]["total"],
            "mem_per_device": a["peak_bytes"],
        }

    # ------------------------------------------------------------ napkin
    def _profile_napkin(self, job: Job, technique: str, n_devices: int,
                        hw: HardwareSpec, device_class: str) -> Profile:
        """Closed-form roofline only — no step is built or run.  The
        cheap deterministic backend for benchmark sweeps."""
        tech = self.library.get(technique)
        plan = tech.plan(job.cfg, n_devices)
        return self._finish(job, technique, n_devices,
                            self._roofline_napkin(job, plan, hw),
                            "napkin", hw, device_class)

    def _finish(self, job: Job, technique: str, n_devices: int,
                terms: Dict[str, float], source: str,
                hw: HardwareSpec, device_class: str) -> Profile:
        tech = self.library.get(technique)
        mem = terms.pop("mem_per_device")
        # roofline: compute and memory overlap with collectives imperfectly;
        # take max(compute, memory) + collective (conservative serial comm)
        t = max(terms["compute_s"], terms["memory_s"]) + terms["collective_s"]
        t *= tech.step_overhead()
        terms["modeled_step_s"] = t
        return Profile(job.name, technique, n_devices, t, mem,
                       mem <= hw.hbm_capacity, source, terms,
                       device_class=device_class)

    def _mem_estimate(self, job: Job, plan: Plan) -> float:
        """Params + AdamW state + activation estimate, per device."""
        tech = self.library.get(plan.technique)
        n_params = param_count(model_spec(job.cfg))
        # fp32 params + mu + nu = 12 bytes/param, sharded per technique
        state = 12.0 * n_params * tech.memory_fraction(job.cfg, plan.n_devices)
        act = self._activation_bytes(job, plan)
        return state + act

    def _activation_bytes(self, job: Job, plan: Plan) -> float:
        cfg = job.cfg
        b, s = job.batch_size, job.seq_len
        if plan.rules.get("batch"):
            b = max(1, b // dict(plan.mesh_axes).get(plan.rules["batch"], 1))
        per_layer = 2.0 * b * s * cfg.d_model * 6  # bf16, ~6 tensors/block
        layers = cfg.num_layers / plan.stages
        if plan.remat:
            return 2.0 * b * s * cfg.d_model * layers  # one residual/layer
        return per_layer * layers

    def _shape_key(self, job: Job, technique: str, mesh_shape) -> Tuple:
        """Jobs that run the same program share one BuiltJob: the step
        depends on the model shape, the batch shape, and the technique's
        mesh — not on the job's name, lr, or seed."""
        cfg = job.cfg
        return (cfg.name, cfg.d_model, cfg.num_layers, job.batch_size,
                job.seq_len, technique, tuple(mesh_shape))

    def _utilization(self, job: Job, plan: Plan) -> float:
        """MXU/SM utilization model: saturates with per-device tokens;
        the knee sits higher for narrow models (small matmuls need more
        batch to fill the MXU/SMs) — this is what makes right-sizing
        matter.  TP shards the *width*, so its effective matmul width
        is d/g."""
        cfg = job.cfg
        g = plan.n_devices
        tokens = job.batch_size * job.seq_len
        tok_dev = tokens if plan.technique == "tp" else tokens / g
        d_eff = cfg.d_model / g if plan.technique == "tp" else cfg.d_model
        knee = 8192.0 * 2048.0 / (d_eff + 2048.0)
        util = (d_eff / (d_eff + 1024.0)) * (tok_dev / (tok_dev + knee))
        return max(util, 0.02)

    @staticmethod
    def _fixed_step_s(cfg, g: int) -> float:
        """Fixed per-step overhead: launch + per-layer collective
        latency, growing with device count."""
        return 2e-3 + 1e-4 * g + cfg.num_layers * 5e-5 * np.log2(max(g, 2))

    def _napkin_raw(self, job: Job, plan: Plan,
                    hw: HardwareSpec) -> Dict[str, float]:
        """6·N·D closed-form raw roofline terms, with the fixed per-step
        latency split out."""
        cfg = job.cfg
        n_params = param_count(model_spec(cfg))
        if cfg.is_moe:
            n_active = n_params * (cfg.moe.top_k / cfg.moe.num_experts)
        else:
            n_active = n_params
        g = plan.n_devices
        tokens = job.batch_size * job.seq_len
        util = self._utilization(job, plan)
        flops = 6.0 * n_active * tokens / g
        compute_s = flops / (hw.flops * util)
        fixed_s = self._fixed_step_s(cfg, g)
        # bytes: params read 3x (fwd, bwd, opt) + activations
        tech = self.library.get(plan.technique)
        bytes_acc = (12.0 * n_params * tech.memory_fraction(cfg, g)
                     + self._activation_bytes(job, plan) * 4)
        coll = 4.0 * n_params / max(g, 1) if g > 1 else 0.0  # grad reduce
        return {
            "compute_s": compute_s,
            "memory_s": bytes_acc / hw.hbm_bw,
            "collective_s": coll / hw.link_bw,
            "fixed_s": fixed_s,
            "hlo_flops": flops * g,
            "collective_bytes": coll * g,
            "mem_per_device": self._mem_estimate(job, plan),
            "utilization": util,
        }

    def _roofline_napkin(self, job: Job, plan: Plan,
                         hw: HardwareSpec) -> Dict[str, float]:
        """6·N·D flops model.

        Includes the two effects that make right-sizing matter (and that
        Saturn exploits): (a) MXU/SM utilization collapses when the
        per-device work gets small (tiny models on many GPUs waste
        capacity), and (b) fixed per-step latency (launch + collective
        setup) grows with device count."""
        raw = self._napkin_raw(job, plan, hw)
        return {
            "compute_s": raw["compute_s"] + raw["fixed_s"],
            "memory_s": raw["memory_s"],
            "collective_s": raw["collective_s"],
            "hlo_flops": raw["hlo_flops"],
            "collective_bytes": raw["collective_bytes"],
            "mem_per_device": raw["mem_per_device"],
            "utilization": raw["utilization"],
        }

    # ---------------------------------------------------------- roofline
    #
    # strategy="roofline": one step analysis per ⟨job-shape, technique,
    # count⟩, per-class efficiency coefficients fit from a handful of
    # real calibration trials — every other combo is predicted, not run.

    def _raw_features(self, job: Job, plan: Plan, hw: HardwareSpec,
                      mode: str = "analytic"
                      ) -> Tuple[Tuple[float, float, float],
                                 Dict[str, float], List[str]]:
        """Raw roofline features for one combo: ``(dominant, link,
        fixed)`` seconds (technique overhead folded in), the term dict
        for the Profile record, and any UNFIT collective kinds (present
        in the step, absent from the ring model — a low-confidence
        signal).

        Op counts come from the combo's own memoized step analysis (a
        step that cannot be analysed raises); under ``mode="napkin"``,
        whose simulated ground truth is the closed-form model itself,
        the closed-form napkin terms stand in.
        """
        g = plan.n_devices
        unfit: List[str] = []
        if mode != "napkin":
            n_base, analysis = self._base_analysis(job, plan)
            scaled = scale_analysis(analysis, n_base, g)
            util = self._utilization(job, plan)
            compute_s = scaled["flops"] / (hw.flops * util)
            memory_s = scaled["bytes_written"] / hw.hbm_bw
            collective_s, unfit = link_seconds(
                scaled["collectives"], g, hw.link_bw) if g > 1 \
                else (0.0, [])
            terms = {"hlo_flops": scaled["flops"] * g,
                     "collective_bytes": scaled["collectives"]["total"],
                     "utilization": util, "hlo_base_n": float(n_base)}
        else:
            raw = self._napkin_raw(job, plan, hw)
            compute_s = raw["compute_s"]
            memory_s = raw["memory_s"]
            collective_s = raw["collective_s"]
            terms = {"hlo_flops": raw["hlo_flops"],
                     "collective_bytes": raw["collective_bytes"],
                     "utilization": raw["utilization"]}
        fixed_s = self._fixed_step_s(job.cfg, g)
        ovh = self.library.get(plan.technique).step_overhead()
        feats = (ovh * max(compute_s, memory_s), ovh * collective_s,
                 ovh * fixed_s)
        terms.update({"compute_s": compute_s, "memory_s": memory_s,
                      "collective_s": collective_s, "fixed_s": fixed_s})
        return feats, terms, unfit

    def _base_analysis(self, job: Job, plan: Plan
                       ) -> Tuple[int, Dict[str, float]]:
        """The ⟨base count, step analysis⟩ this combo's raw terms scale
        from: always the combo's own count, since a fake process group
        hosts any count (the JAX package falls back to the largest count
        its local devices host, and to the napkin terms below that)."""
        return plan.n_devices, self._analysis(job, plan)

    def _predict_roofline(self, job: Job, technique: str, n_devices: int,
                          hw: HardwareSpec, device_class: str,
                          cal: ClassCalibration,
                          mode: str = "analytic") -> Profile:
        """One predicted Profile (``source="roofline"``) with a
        confidence term the fallback knob acts on."""
        tech = self.library.get(technique)
        plan = tech.plan(job.cfg, n_devices)
        feats, terms, unfit = self._raw_features(job, plan, hw, mode)
        t = cal.predict(feats)
        mem = self._mem_estimate(job, plan)
        confidence = 1.0
        if cal.n_points < 2:
            confidence *= 0.5
        if cal.residual > 0.25:
            confidence *= 0.5
        if unfit:
            confidence *= 0.25
            terms["unfit_collectives"] = float(len(unfit))
        # memory-boundary cases: the fit-or-doesn't-fit call is made on
        # an ESTIMATE — within a few percent of capacity the analytic
        # answer is a coin flip, so flag it for escalation
        if hw.hbm_capacity > 0 and \
                0.95 <= mem / hw.hbm_capacity <= 1.05:
            confidence *= 0.25
        terms["confidence"] = confidence
        terms["modeled_step_s"] = t
        return Profile(job.name, technique, n_devices, t, mem,
                       mem <= hw.hbm_capacity, "roofline", terms,
                       device_class=device_class)

    # -------------------------------------------------------------- misc
    def flush(self) -> None:
        """Write the cache to disk now (atomic temp-file + rename)."""
        with self._lock:
            self._flush_locked()

    # flushes are batched, so direct profile() callers could otherwise
    # lose the tail of their (possibly expensive empirical) trials when
    # the runner goes away without an explicit flush()
    def __enter__(self) -> "TrialRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()

    def __del__(self):
        try:
            self.flush()
        except Exception:
            pass               # interpreter teardown: best effort only

    def _flush_locked(self) -> None:
        if not self.cache_path or not self._dirty:
            return
        path = os.path.abspath(self.cache_path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"version": CACHE_VERSION,
                   "profiles": [p.to_json() for p in self._cache.values()],
                   "calibration": {dc: c.to_json()
                                   for dc, c in self.calibration.items()}}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        self._dirty = 0

    # back-compat alias (pre-batching callers)
    _flush = flush
