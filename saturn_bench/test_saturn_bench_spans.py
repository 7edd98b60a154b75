"""The readers of the program's spans and counters on hand-made records
and traces: innermost charging (a remat recompute nested in a backward
interval, a span opened at the same instant as its parent), shares
against a hand count, the MoE phases summing to 100%, idle within the
step, and None where there is nothing to read."""
import types

import pytest

from repro_torch.spans import BACKWARD, FORWARD, RECOMPUTE, Occurrence, \
    Record
from saturn_bench import cells, spans_read
from saturn_bench.trace import Trace

NEW = ("attention_share.train", "ffn_share.train", "head_share.train",
       "moe_route_share.train", "moe_dispatch_share.train",
       "moe_experts_share.train", "moe_combine_share.train",
       "moe_slot_use.train", "device_idle_in_step.train")
MOE_PARTS = (("moe.route", 5, 2), ("moe.dispatch", 2, 1),
             ("moe.experts", 10, 7), ("moe.combine", 3, 2))


def _occ(name, phase, start, end):
    return Occurrence(name, phase, start * 1e-3, end * 1e-3, start, end)


def _moe(phase, at, widths):
    out = []
    for name, width in widths:
        out.append(_occ(name, phase, at, at + width))
        at += width
    return out


def _record():
    """One step on a stream of 100 ms (in order of the starts): attention
    10, the MoE FFN 20 (its four parts 5, 2, 10, 3, the first opened at
    the FFN's own start), the head 5; the backward: the head 5, the FFN
    30 with the block's recompute inside it (attention 6, FFN 12 of
    parts 2, 1, 7, 2), attention 10; 20 outside every layer."""
    spans = [_occ("step", FORWARD, 0, 100),
             _occ("attention", FORWARD, 10, 20),
             _occ("ffn", FORWARD, 20, 40)]
    spans += _moe(FORWARD, 20, [(n, f) for n, f, _ in MOE_PARTS])
    spans += [_occ("head", FORWARD, 40, 45), _occ("head", BACKWARD, 45, 50),
              _occ("ffn", BACKWARD, 50, 80),
              _occ("attention", RECOMPUTE, 52, 58),
              _occ("ffn", RECOMPUTE, 58, 70)]
    spans += _moe(RECOMPUTE, 58, [(n, r) for n, _, r in MOE_PARTS])
    spans += [_occ("attention", BACKWARD, 80, 90),
              _occ("attention", FORWARD, 100, 130)]    # outside the step
    return Record(spans, {"moe.pairs_kept": 380, "moe.slots": 640,
                          "moe.pairs": 512})


def _run(device=True, host=()):
    trace = Trace(10.0, [(1.0, 2.0, "kernel")] if device else [],
                  list(host))
    return types.SimpleNamespace(trace=trace)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans_read, "record", _record)


def test_innermost_charging_with_a_recompute_in_a_backward():
    c = spans_read.charged(_record(), spans_read.LAYERS)
    # the recompute's 6 + 12 ms go to its own spans, not to the
    # backward ``ffn`` that holds it; the FFN's parts count as ``ffn``
    assert c == pytest.approx({"attention": 10 + 6 + 10,
                               "ffn": 20 + (30 - 18) + 12,
                               "head": 5 + 5, "step": 20})
    m = spans_read.charged(_record(), spans_read.MOE)
    assert m == pytest.approx({n: f + r for n, f, r in MOE_PARTS}
                              | {"step": 100 - 32})


def test_layer_shares_equal_a_hand_count(recorded):
    read = {n: cells.reader(n)(_run()) for n in NEW}
    assert read["attention_share.train"] == pytest.approx(26.0)
    assert read["ffn_share.train"] == pytest.approx(44.0)
    assert read["head_share.train"] == pytest.approx(10.0)
    assert read["moe_slot_use.train"] == pytest.approx(100 * 380 / 640)


def test_moe_phases_sum_to_all(recorded):
    shares = {n: cells.reader(f"moe_{n.split('.')[1]}_share.train")(_run())
              for n, _, _ in MOE_PARTS}
    for n, f, r in MOE_PARTS:
        assert shares[n] == pytest.approx(100 * (f + r) / 32)
    assert sum(shares.values()) == pytest.approx(100.0)


def test_idle_within_the_step():
    # busy 1-2 and (below) 4-6 of a 10 s window; the host inside a
    # step over 0.5-5 and 7-9: idle 0.5-1, 2-4 and 7-9 lies in a step
    run = _run(host=[(0.5, 5.0, "step"), (7.0, 9.0, "step"),
                     (0.0, 10.0, "aten::mul")])
    run.trace.device.append((4.0, 6.0, "kernel"))
    read = cells.reader("device_idle_in_step.train")
    assert read(run) == pytest.approx(45.0)
    assert read(_run(host=[(0.0, 10.0, "aten::mul")])) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_device_events_or_spans(name, recorded, monkeypatch):
    read = cells.reader(name)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(_run(device=False, host=[(0.0, 10.0, "step")])) is None
    if name != "device_idle_in_step.train":
        # a tree without ``repro_torch.spans``
        monkeypatch.setattr(spans_read, "record", lambda: None)
        assert read(_run()) is None
        # a window that timed nothing on the card (the CPU)
        monkeypatch.setattr(spans_read, "record", lambda: Record(
            [o._replace(device_start=None, device_end=None)
             for o in _record().spans], {}))
        assert read(_run()) is None
