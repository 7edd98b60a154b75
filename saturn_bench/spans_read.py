"""What the program's spans and counters (``repro_torch.spans``) say
about the profiled window, for the per-layer readers.

The program records each span's occurrences on the card's stream (CUDA
events) and its counters while a profiler runs; ``record()`` fetches
them after the window.  A tree without spans gives None, and so does
every reader.

``charged`` puts each instant of the stream timeline inside a ``step``
occurrence down to the innermost occurrence open at it, of the names a
metric compares: the one that started last (of equal starts, the later
in the record).  So a remat block's second forward, which runs inside
its ``ffn`` backward, is charged to the recompute's own ``attention``
and ``ffn``; the MoE FFN's four spans count as ``ffn`` where the layers
are compared; and the time of a step outside every layer (embedding,
optimizer) is charged to ``step`` itself.
"""
from __future__ import annotations

from typing import Dict, Optional

STEP = "step"
LAYERS = ("attention", "ffn", "head")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def record():
    """The program's record of the latest profiled window; None where
    the program has no spans."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.record()


def charged(rec, names) -> Dict[str, float]:
    """Stream milliseconds inside the record's ``step`` occurrences, by
    the innermost occurrence open at each instant among ``step`` and
    ``names``."""
    keep = set(names) | {STEP}
    occ = [(o.device_start, i, o.device_end, o.name)
           for i, o in enumerate(rec.spans)
           if o.name in keep and o.device_start is not None
           and o.device_end is not None]
    cuts = sorted({t for s, _, e, _ in occ for t in (s, e)})
    out: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s, i, n) for s, i, e, n in occ if s <= a and e >= b]
        if any(n == STEP for _, _, n in open_):
            name = max(open_)[2]
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def _record(run):
    if run.trace is None or not run.trace.device:
        return None
    return record()


def _timed(rec, name: str) -> bool:
    return any(o.name == name and o.device_start is not None
               for o in rec.spans)


def step_share(run, name: str) -> Optional[float]:
    """The share (%) of the window's ``step`` stream time charged to the
    layer ``name`` (one of ``LAYERS``); None where no ``name``
    occurrence was timed."""
    rec = _record(run)
    if rec is None or not _timed(rec, name):
        return None
    c = charged(rec, LAYERS)
    total = sum(c.values())
    return 100.0 * c.get(name, 0.0) / total if total else None


def moe_share(run, name: str) -> Optional[float]:
    """The share (%) of the four ``moe.*`` spans' stream time charged to
    ``name``."""
    rec = _record(run)
    c = charged(rec, MOE) if rec is not None else {}
    total = sum(c.get(n, 0.0) for n in MOE)
    return 100.0 * c.get(name, 0.0) / total if total else None


def counter_ratio(run, num: str, den: str) -> Optional[float]:
    """100 · counter ``num`` over counter ``den``; None where ``den``
    was not counted."""
    rec = _record(run)
    if rec is None or not rec.counters.get(den):
        return None
    return 100.0 * rec.counters.get(num, 0) / rec.counters[den]
