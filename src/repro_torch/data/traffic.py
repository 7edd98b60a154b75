"""Seeded request-traffic generators for serving fleets.

Traces are tuples of request arrival times (seconds over
``[0, duration_s)``) drawn from a nonhomogeneous Poisson process via
thinning, mirroring :func:`repro_torch.core.chaos.poisson_node_failures`: the
candidate stream is generated ONCE at ``max_rps`` and each candidate
survives iff its uniform mark is below ``rate(t) / max_rps``.  Sweeping
the rate under a fixed ``max_rps`` and seed therefore yields NESTED
traces — every request in a lower-rate trace also appears, at the same
timestamp, in every higher-rate one.  That is what lets a load sweep
attribute SLO misses to the traffic level instead of to resampling
noise (and is pinned by tests/test_traffic.py).

Two shapes cover the paper-scale scenarios:

- :func:`diurnal_trace` — a day/night sinusoid around a mean rate, the
  steady-state production pattern fleet autoscaling must track;
- :func:`bursty_trace` — a low base rate punctuated by periodic square
  bursts, the flash-crowd pattern that punishes peak-provisioning.
"""
from __future__ import annotations

import math
import random
from typing import Callable, List, Tuple


def _thinned_arrivals(rate_fn: Callable[[float], float], duration_s: float,
                      max_rps: float, seed: int) -> Tuple[float, ...]:
    """Nonhomogeneous Poisson arrivals on ``[0, duration_s)`` by
    thinning a homogeneous ``max_rps`` stream.  ``rate_fn(t)`` must
    never exceed ``max_rps``."""
    if duration_s <= 0 or max_rps <= 0:
        return ()
    rng = random.Random(seed)
    out: List[float] = []
    t = 0.0
    while True:
        # draw the gap AND the thinning mark unconditionally so the
        # underlying stream is identical across rates (superset property)
        t += rng.expovariate(max_rps)
        keep = rng.random() * max_rps < rate_fn(t)
        if t >= duration_s:
            break
        if keep:
            out.append(t)
    return tuple(out)


def diurnal_trace(mean_rps: float, duration_s: float, *, seed: int = 0,
                  period_s: float = 3600.0, amplitude: float = 0.5,
                  phase: float = 0.0,
                  max_rps: float = None) -> Tuple[float, ...]:
    """Sinusoidal day/night traffic: rate(t) = ``mean_rps`` x
    ``(1 + amplitude * sin(2*pi*t/period_s + phase))``.

    ``max_rps`` is the thinning cap; traces generated with the same
    ``seed`` and ``max_rps`` nest across ``mean_rps`` (superset
    property).  The default cap is the trace's own peak, which keeps a
    single call efficient but opts out of nesting — sweeps must pin the
    cap to the highest rate swept, exactly like the chaos failure
    sweeps.
    """
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    if mean_rps < 0:
        raise ValueError("mean_rps must be >= 0")
    peak = mean_rps * (1.0 + amplitude)
    cap = peak if max_rps is None else max_rps
    if peak > cap * (1 + 1e-12):
        raise ValueError(f"peak rate {peak} exceeds max_rps {cap}")
    w = 2.0 * math.pi / period_s

    def rate(t: float) -> float:
        return mean_rps * (1.0 + amplitude * math.sin(w * t + phase))

    return _thinned_arrivals(rate, duration_s, cap, seed)


def bursty_trace(base_rps: float, duration_s: float, *, seed: int = 0,
                 burst_rps: float = None, burst_every_s: float = 1800.0,
                 burst_len_s: float = 300.0,
                 max_rps: float = None) -> Tuple[float, ...]:
    """Flash-crowd traffic: ``base_rps`` everywhere, jumping to
    ``burst_rps`` (default ``4 * base_rps``) for ``burst_len_s`` at the
    start of every ``burst_every_s`` interval.

    Same thinning/nesting contract as :func:`diurnal_trace`: traces with
    the same ``seed`` and ``max_rps`` nest across rate scalings.
    """
    if base_rps < 0:
        raise ValueError("base_rps must be >= 0")
    if burst_rps is None:
        burst_rps = 4.0 * base_rps
    if burst_rps < base_rps:
        raise ValueError(f"burst_rps {burst_rps} below base_rps {base_rps}")
    cap = burst_rps if max_rps is None else max_rps
    if burst_rps > cap * (1 + 1e-12):
        raise ValueError(f"burst_rps {burst_rps} exceeds max_rps {cap}")

    def rate(t: float) -> float:
        return burst_rps if (t % burst_every_s) < burst_len_s else base_rps

    return _thinned_arrivals(rate, duration_s, cap, seed)


def window_rates(trace, window_s: float, duration_s: float
                 ) -> Tuple[float, ...]:
    """Mean arrival rate (req/s) per ``window_s`` window over
    ``[0, duration_s)`` — the planner's view of a trace."""
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    n = max(1, int(math.ceil(duration_s / window_s)))
    counts = [0] * n
    for t in trace:
        if 0.0 <= t < duration_s:
            counts[min(n - 1, int(t // window_s))] += 1
    return tuple(c / window_s for c in counts)
