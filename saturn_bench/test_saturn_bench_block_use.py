"""The reader of ``attention_block_use.train`` on hand-made records: the
share of (q block, kv block) pairs that blockwise attention visited, and
None where there is nothing to read."""
import types

import pytest

from repro_torch.spans import FORWARD, Occurrence, Record
from saturn_bench import cells, spans_read
from saturn_bench.trace import Trace

NAME = "attention_block_use.train"


def _record(counters):
    spans = [Occurrence("step", FORWARD, 0.0, 0.1, 0.0, 100.0),
             Occurrence("attention", FORWARD, 0.01, 0.02, 10.0, 20.0)]
    return Record(spans, counters)


def _run(device=True):
    trace = Trace(10.0, [(1.0, 2.0, "kernel")] if device else [],
                  [(0.0, 10.0, "step")])
    return types.SimpleNamespace(trace=trace)


@pytest.mark.parametrize("run_, of, want", [
    (36, 64, 56.25),      # causal, S 4096 in blocks of 512
    (21, 64, 32.8125),    # a window that drops leading kv blocks
    (64, 64, 100.0)])     # every pair, as an all-blocks loop visits
def test_block_use_is_the_counters_share(run_, of, want, monkeypatch):
    monkeypatch.setattr(spans_read, "record", lambda: _record(
        {"attention.blocks_run": run_, "attention.blocks": of}))
    assert cells.reader(NAME)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_counter", "no_spans", "no_trace",
                                  "no_device_events"])
def test_block_use_none_without_something_to_read(case, monkeypatch):
    # a program without the attention counters still records spans
    rec = None if case == "no_spans" else _record(
        {"moe.pairs": 512} if case == "no_counter" else
        {"attention.blocks_run": 36, "attention.blocks": 64})
    monkeypatch.setattr(spans_read, "record", lambda: rec)
    run = (types.SimpleNamespace(trace=None) if case == "no_trace"
           else _run(device=case != "no_device_events"))
    assert cells.reader(NAME)(run) is None
