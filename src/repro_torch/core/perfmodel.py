"""Performance-model layer: throughput curves over GPU count.

The paper's Trial Runner keeps profiling overhead under ~5% of workload
runtime by profiling only a *subset* of ⟨model, parallelism, GPU-count⟩
combinations and interpolating the rest (Saturn §2; the VLDB version
makes the same point about amortized, cached trial runs).  This module
is that layer:

- :func:`select_anchor_counts` picks the geometric subset of GPU counts
  that gets REAL trials — always including the technique-feasibility
  boundary counts (smallest and largest valid);
- :class:`ThroughputCurve` fits one ⟨job, technique⟩ scaling curve to
  those anchors — piecewise power-law, i.e. linear in (log g, log t)
  space, which preserves monotonicity between anchors and matches the
  ``t ∝ g^(-efficiency)`` shape of data/model-parallel scaling — and
  evaluates ``step_time(g)``, ``mem(g)`` and ``feasible(g)`` at ANY
  count.  Extrapolation beyond the anchored range continues the edge
  segment's slope, clamped to [-1, +1] in log-log space: never better
  than perfect linear scaling, never a worse-than-linear slowdown;
- :class:`PerfModel` is the consumer facade: a read-only Mapping with
  the legacy ``profiles[(job, tech, g)] -> Profile`` contract (missing
  counts are synthesized from the curve, ``source="interpolated"``),
  plus curve-native accessors (``curve()``, ``curves_for()``,
  ``step_time()``) for the Solver, the baselines and the runtime's
  introspection replans.

Feasibility at a count ``g`` has two independent parts, and the curve
keeps them separate: *validity* (the technique's ``search_space`` —
exact, computed for every count without a trial) and *memory fit*
(``mem(g) <= hbm_capacity`` — interpolated between anchors).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .job import DEFAULT_CLASS
from .profiler import Profile

# Extrapolation slope clamp in log-log space: -1 is perfect linear
# scaling (t halves when g doubles); +1 bounds observed slowdowns.
_SLOPE_LO = -1.0
_SLOPE_HI = 1.0


def select_anchor_counts(valid_counts: Iterable[int],
                         ratio: float = 2.0) -> List[int]:
    """The geometric subset of ``valid_counts`` that gets real trials.

    Walks the sorted valid counts keeping every count that is at least
    ``ratio`` times the previously kept one, and always keeps the
    smallest and largest valid counts (the technique-feasibility
    boundary points the curve must not extrapolate across).
    """
    vs = sorted(set(int(g) for g in valid_counts))
    if not vs:
        return []
    anchors = [vs[0]]
    target = vs[0] * ratio
    for g in vs[1:]:
        if g >= target - 1e-9:
            anchors.append(g)
            target = g * ratio
    if anchors[-1] != vs[-1]:
        anchors.append(vs[-1])
    return anchors


def _loglog_eval(lxs: np.ndarray, lys: np.ndarray, g: float) -> float:
    """Piecewise-linear evaluation in log-log space with slope-clamped
    extrapolation past either end."""
    x = math.log(g)
    if len(lxs) == 1:
        return math.exp(float(lys[0]))
    if x <= lxs[0]:
        s = (lys[1] - lys[0]) / (lxs[1] - lxs[0])
        s = min(max(s, _SLOPE_LO), _SLOPE_HI)
        return math.exp(float(lys[0] + s * (x - lxs[0])))
    if x >= lxs[-1]:
        s = (lys[-1] - lys[-2]) / (lxs[-1] - lxs[-2])
        s = min(max(s, _SLOPE_LO), _SLOPE_HI)
        return math.exp(float(lys[-1] + s * (x - lxs[-1])))
    return math.exp(float(np.interp(x, lxs, lys)))


class ThroughputCurve:
    """One ⟨job, technique, device class⟩ scaling curve over GPU count,
    fit to real trial anchors.  On heterogeneous clusters every device
    class gets its own curve (own anchors, own HBM capacity)."""

    def __init__(self, job: str, technique: str, hbm_capacity: float,
                 anchors: Dict[int, Profile],
                 valid: Iterable[int], domain: Iterable[int],
                 device_class: str = DEFAULT_CLASS):
        self.job = job
        self.technique = technique
        self.hbm_capacity = hbm_capacity
        self.device_class = device_class
        self.anchors = {int(g): p for g, p in sorted(anchors.items())}
        self.valid = frozenset(int(g) for g in valid)
        self.domain = frozenset(int(g) for g in domain)
        # fit arrays: anchors with finite measurements (memory-infeasible
        # anchors still carry real numbers and inform the fit; search-
        # space-invalid ones are inf and excluded)
        fit = [(g, p) for g, p in self.anchors.items()
               if math.isfinite(p.step_time_s) and p.step_time_s > 0]
        self._fit_counts = [g for g, _ in fit]
        if fit:
            self._lg = np.log([g for g, _ in fit])
            self._lt = np.log([p.step_time_s for _, p in fit])
            self._lm = np.log([max(p.mem_per_device, 1.0) for _, p in fit])
        else:
            self._lg = self._lt = self._lm = np.zeros(0)

    # ------------------------------------------------------------- eval
    def valid_at(self, g: int) -> bool:
        """Search-space validity (exact; no trial involved)."""
        if g in self.valid:
            return True
        if g in self.domain:
            return False
        # counts outside the modeled domain: trust interpolation only
        # inside the anchored range
        return bool(self._fit_counts) and \
            self._fit_counts[0] <= g <= self._fit_counts[-1]

    def step_time(self, g: int) -> float:
        g = int(g)
        if g in self.anchors:
            return self.anchors[g].step_time_s
        if not self.valid_at(g) or not self._fit_counts:
            return float("inf")
        return _loglog_eval(self._lg, self._lt, g)

    def mem(self, g: int) -> float:
        g = int(g)
        if g in self.anchors:
            return self.anchors[g].mem_per_device
        if not self.valid_at(g) or not self._fit_counts:
            return float("inf")
        return _loglog_eval(self._lg, self._lm, g)

    def feasible(self, g: int) -> bool:
        g = int(g)
        if g in self.anchors:
            return self.anchors[g].feasible
        if not self.valid_at(g):
            return False
        m = self.mem(g)
        return math.isfinite(m) and m <= self.hbm_capacity and \
            math.isfinite(self.step_time(g))

    def profile(self, g: int) -> Profile:
        """A Profile record at any count: the anchor itself where one
        exists, an interpolated point everywhere else.  Evaluates each
        curve exactly once per field (policies rebuild grids every
        replan, so this is the hot path)."""
        g = int(g)
        if g in self.anchors:
            return self.anchors[g]
        terms = {"n_anchors": float(len(self._fit_counts))}
        if not self.valid_at(g) or not self._fit_counts:
            return Profile(self.job, self.technique, g, float("inf"),
                           float("inf"), False, "interpolated", terms,
                           device_class=self.device_class)
        t = _loglog_eval(self._lg, self._lt, g)
        m = _loglog_eval(self._lg, self._lm, g)
        feas = math.isfinite(t) and math.isfinite(m) and \
            m <= self.hbm_capacity
        return Profile(self.job, self.technique, g, t, m, feas,
                       "interpolated", terms,
                       device_class=self.device_class)


class PerfModel(Mapping):
    """Curves for a whole workload, with the legacy Mapping contract.

    Single-class models: iteration / ``len`` / ``items()`` enumerate
    ``(job, technique, g)`` over the model's count grid restricted to
    search-space-valid counts — exactly the keys an exhaustive
    ``profile_all`` dict would hold — so every dict-shaped consumer (the
    MILPs, baselines, the runtime's noise model) works unchanged.
    ``__getitem__`` additionally accepts off-grid counts: curves are
    continuous, so introspection replans may evaluate counts nobody
    profiled.

    Heterogeneous models (curves keyed ``(job, tech, device_class)``)
    enumerate 4-tuple keys ``(job, tech, device_class, g)`` over each
    class's own count grid; 3-tuple lookups resolve against the
    "default" class only, so class-blind code cannot silently read the
    wrong device generation.
    """

    def __init__(self, curves: Dict[Tuple, ThroughputCurve],
                 counts: Iterable[int],
                 counts_by_class: Optional[Dict[str, Iterable[int]]] = None):
        self._curves: Dict[Tuple[str, str, str], ThroughputCurve] = {}
        for k, c in curves.items():
            if len(k) == 2:
                k = (k[0], k[1], getattr(c, "device_class", DEFAULT_CLASS))
            self._curves[k] = c
        self.classes = sorted({k[2] for k in self._curves}) or \
            [DEFAULT_CLASS]
        self.hetero = self.classes != [DEFAULT_CLASS]
        self.counts = sorted(set(int(c) for c in counts))
        self._counts_by_class = {
            dc: sorted(set(int(c) for c in cs))
            for dc, cs in (counts_by_class or {}).items()}
        for dc in self.classes:
            self._counts_by_class.setdefault(dc, self.counts)
        if self.hetero:
            self._keys = [(j, t, dc, g)
                          for (j, t, dc), c in self._curves.items()
                          for g in self._counts_by_class[dc]
                          if g in c.valid]
        else:
            self._keys = [(j, t, g)
                          for (j, t, dc), c in self._curves.items()
                          for g in self._counts_by_class[dc]
                          if g in c.valid]

    def counts_for(self, device_class: str = DEFAULT_CLASS) -> List[int]:
        return self._counts_by_class.get(device_class, self.counts)

    # --------------------------------------------------- Mapping contract
    def __getitem__(self, key: Tuple) -> Profile:
        if len(key) == 4:
            job, tech, dc, g = key
        elif len(key) == 3:
            (job, tech, g), dc = key, DEFAULT_CLASS
        else:
            raise KeyError(key)
        c = self._curves.get((job, tech, dc))
        if c is None:
            raise KeyError(key)
        return c.profile(int(g))

    def __iter__(self) -> Iterator[Tuple]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    # ----------------------------------------------------- curve access
    def curve(self, job: str, technique: str,
              device_class: str = DEFAULT_CLASS) -> ThroughputCurve:
        return self._curves[(job, technique, device_class)]

    def curves_for(self, job: str,
                   device_class: Optional[str] = None
                   ) -> List[ThroughputCurve]:
        """All curves for one job; ``device_class`` filters to one
        class (single-class models hold everything under "default")."""
        return [c for (j, _, dc), c in self._curves.items()
                if j == job and (device_class is None
                                 or dc == device_class)]

    def step_time(self, job: str, technique: str, g: int,
                  device_class: str = DEFAULT_CLASS) -> float:
        return self._curves[(job, technique, device_class)].step_time(g)

    def mem(self, job: str, technique: str, g: int,
            device_class: str = DEFAULT_CLASS) -> float:
        return self._curves[(job, technique, device_class)].mem(g)

    def feasible(self, job: str, technique: str, g: int,
                 device_class: str = DEFAULT_CLASS) -> bool:
        c = self._curves.get((job, technique, device_class))
        return c.feasible(g) if c is not None else False

    # ------------------------------------------------------------ stats
    def anchor_keys(self) -> set:
        """The combos backed by real trials: (job, technique, g) on
        single-class models, (job, technique, device_class, g) on
        heterogeneous ones — matching the Mapping key shape."""
        if self.hetero:
            return {(c.job, c.technique, dc, g)
                    for (_, _, dc), c in self._curves.items()
                    for g in c.anchors}
        return {(c.job, c.technique, g)
                for c in self._curves.values() for g in c.anchors}

    def n_anchors(self) -> int:
        return sum(len(c.anchors) for c in self._curves.values())

    def real_anchor_keys(self) -> set:
        """Like :meth:`anchor_keys`, but only combos whose anchor came
        from a real trial — roofline predictions and interpolated points
        sit in ``anchors`` too (the curve serves them directly), and a
        held-out error measurement must not score a prediction against
        itself."""
        predicted = ("roofline", "interpolated")
        if self.hetero:
            return {(c.job, c.technique, dc, g)
                    for (_, _, dc), c in self._curves.items()
                    for g, p in c.anchors.items()
                    if p.source not in predicted}
        return {(c.job, c.technique, g)
                for c in self._curves.values()
                for g, p in c.anchors.items()
                if p.source not in predicted}

    def to_dict(self) -> Dict[Tuple, Profile]:
        """Materialize the full grid as a plain dict (legacy export)."""
        return {k: self[k] for k in self._keys}


class ObservedProfiles(Mapping):
    """A read-only overlay of MEASURED step times on top of a base
    profile representation (a plain dict or a :class:`PerfModel`).

    The real-execution backend records observed per-step wall times as
    launches run; introspection replans plan over this view, so the
    combos actually executing carry ground truth while everything else
    keeps its estimate — the paper's introspection loop closed over
    measured throughput.  This overlay is estimator-agnostic: roofline
    predictions (``source="roofline"``) are replaced by observations
    exactly like empirical or analytic profiles.  The base is never mutated, and the overlay
    enumerates exactly the base's keys (same Mapping contract every
    dict-shaped consumer already holds).  ``observed`` maps the base's
    own profile keys (see :func:`profile_key`) to measured seconds.
    """

    def __init__(self, base, observed: Dict[Tuple, float]):
        self._base = base
        self._observed = dict(observed)

    def _lookup(self, key: Tuple) -> Optional[float]:
        # bases accept both 3-tuple (job, tech, g) and default-class
        # 4-tuple keys for the same combo; normalize before matching
        o = self._observed.get(key)
        if o is not None:
            return o
        if len(key) == 4 and key[2] == DEFAULT_CLASS:
            return self._observed.get((key[0], key[1], key[3]))
        if len(key) == 3:
            return self._observed.get(
                (key[0], key[1], DEFAULT_CLASS, key[2]))
        return None

    def __getitem__(self, key: Tuple) -> Profile:
        p = self._base[key]
        o = self._lookup(key)
        if o is None:
            return p
        return dataclasses.replace(p, step_time_s=float(o),
                                   source="observed")

    def __iter__(self) -> Iterator[Tuple]:
        return iter(self._base)

    def __len__(self) -> int:
        return len(self._base)


class MergedProfiles(Mapping):
    """Several profile Mappings behind one read-only view, first hit
    wins.  The serving path needs this: training step times live in a
    :class:`PerfModel` (or dict) while serve-replica step times are a
    separate dict keyed ``(name, "serve", class, gpus)`` — merging keeps
    both answerable through the same adapters without mutating either.
    Note a wrapped :class:`PerfModel` is consulted through its
    enumerated grid keys here (the dict path), not its curve API."""

    def __init__(self, *parts):
        self._parts = parts

    def __getitem__(self, key: Tuple) -> Profile:
        for p in self._parts:
            try:
                return p[key]
            except KeyError:
                continue
        raise KeyError(key)

    def __iter__(self) -> Iterator[Tuple]:
        seen = set()
        for p in self._parts:
            for k in p:
                if k not in seen:
                    seen.add(k)
                    yield k

    def __len__(self) -> int:
        return sum(1 for _ in self)


# ------------------------------------------------- dict/model adapters
#
# Legacy dicts come in two shapes: 3-tuple keys (job, tech, g) for
# single-class clusters and 4-tuple keys (job, tech, device_class, g)
# for heterogeneous ones.  The adapters below accept both, plus
# PerfModels, so planners/runtime never branch on the representation.

def _dict_key(profiles, job: str, tech: str, g: int,
              device_class: Optional[str]) -> Tuple:
    """The key under which a plain dict holds this combo."""
    dc = device_class or DEFAULT_CLASS
    k4 = (job, tech, dc, g)
    if k4 in profiles:
        return k4
    return (job, tech, g)


def profile_key(profiles, job: str, tech: str, g: int,
                device_class: Optional[str] = None) -> Tuple:
    """The exact key ``profiles`` uses for this combo — the key the
    runtime's noise model is seeded under."""
    if isinstance(profiles, PerfModel):
        dc = device_class or DEFAULT_CLASS
        return (job, tech, dc, g) if profiles.hetero else (job, tech, g)
    return _dict_key(profiles, job, tech, g, device_class)


def iter_job_profiles(profiles, job_name: str,
                      device_class: Optional[str] = None
                      ) -> Iterator[Tuple[str, int, Profile]]:
    """Yield (technique, g, Profile) for one job on ONE device class
    (default: the "default" class) from either a profile dict or a
    :class:`PerfModel`."""
    dc = device_class or DEFAULT_CLASS
    if isinstance(profiles, PerfModel):
        for curve in profiles.curves_for(job_name, device_class=dc):
            for g in profiles.counts_for(dc):
                if g in curve.valid:
                    yield curve.technique, g, curve.profile(g)
        return
    for key, p in profiles.items():
        if len(key) == 4:
            jn, tech, kdc, g = key
            if jn == job_name and kdc == dc:
                yield tech, g, p
        else:
            jn, tech, g = key
            if jn == job_name and dc == DEFAULT_CLASS:
                yield tech, g, p


def iter_job_class_profiles(profiles, job_name: str
                            ) -> Iterator[Tuple[str, str, int, Profile]]:
    """Yield (technique, device_class, g, Profile) for one job across
    EVERY device class the profiles cover."""
    if isinstance(profiles, PerfModel):
        for dc in profiles.classes:
            for tech, g, p in iter_job_profiles(profiles, job_name, dc):
                yield tech, dc, g, p
        return
    for key, p in profiles.items():
        if len(key) == 4:
            jn, tech, dc, g = key
        else:
            (jn, tech, g), dc = key, DEFAULT_CLASS
        if jn == job_name:
            yield tech, dc, g, p


def step_time_of(profiles, job: str, tech: str, g: int,
                 device_class: Optional[str] = None) -> float:
    """Estimated step time from either representation; curve-backed
    models answer at any count, dicts only at profiled ones."""
    if isinstance(profiles, PerfModel):
        return profiles.step_time(job, tech, g,
                                  device_class or DEFAULT_CLASS)
    return profiles[_dict_key(profiles, job, tech, g,
                              device_class)].step_time_s


def lookup_profile(profiles, job: str, tech: str, g: int,
                   device_class: Optional[str] = None
                   ) -> Optional[Profile]:
    """Profile record from either representation (None if unknown)."""
    try:
        return profiles[profile_key(profiles, job, tech, g, device_class)]
    except KeyError:
        return None
