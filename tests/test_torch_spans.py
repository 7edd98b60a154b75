"""The training step's spans and counters (``repro_torch.spans``) on the
CPU: nothing recorded and no hook without a profiler, the same step
bit for bit with one; under a profiler, FUNCTION-scope host ranges
(a user-scope range would be mirrored onto the card as a device
annotation), every block's forward, recompute and backward
occurrences, the MoE counters against a direct count, and the
attention block counters."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core.library import ParallelismLibrary
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import moe
from repro_torch.models.params import params_to_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallelism.build import BuiltJob

NAMES = ("step", "attention", "ffn", "head", "moe.route", "moe.dispatch",
         "moe.experts", "moe.combine")
B, S = 2, 16


def _job(arch="olmoe-1b-7b", technique="remat-offload"):
    cfg = get_config(arch).reduced()
    plan = ParallelismLibrary().get(technique).plan(cfg, 1)
    job = BuiltJob(cfg, plan, AdamWConfig(), device="cpu")
    batch = job.place_batch(next(SyntheticLM(cfg).batches(B, S,
                                                          device="cpu")))
    return cfg, job, batch


def _step(job, batch, traced: bool):
    params, opt = job.init(0)
    if not traced:
        return job.step(params, opt, batch), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = job.step(params, opt, batch)
    return out, prof


@pytest.fixture(scope="module")
def traced_moe():
    """One remat-offload step of olmoe-1b-7b.reduced() under the CPU
    profiler, with every call of ``route`` counted directly beside it."""
    cfg, job, batch = _job()
    direct = []
    route = moe.route

    def counted(*a, **k):
        r = route(*a, **k)
        direct.append((torch._C._current_graph_task_id() != -1,
                       int((r.slot_of_pair >= 0).sum())))
        return r

    moe.route = counted
    try:
        _, prof = _step(job, batch, traced=True)
    finally:
        moe.route = route
    return cfg, prof, spans.record(), direct


def test_no_profiler_records_nothing_and_steps_alike(monkeypatch):
    cfg, job, batch = _job()
    (pa, oa, ma), _ = _step(job, batch, traced=True)
    before = spans.record()

    def refuse(*a, **k):
        raise AssertionError("a span was opened without a profiler")

    with monkeypatch.context() as m:
        m.setattr(spans, "_Span", refuse)
        (pb, ob, mb), _ = _step(job, batch, traced=False)
        assert spans.span("step") is spans.NULL and not spans.counting()
    assert spans.record() is before
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(params_to_numpy({"p": pa, "o": oa}).values(),
                    params_to_numpy({"p": pb, "o": ob}).values()):
        np.testing.assert_array_equal(a, b)


def test_ranges_are_function_scope(traced_moe):
    _, prof, _, _ = traced_moe
    seen = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES:
            assert e.scope() == 0 and not e.is_user_annotation(), e.name()
            seen[e.name()] += 1
    assert set(seen) == set(NAMES)
    # forward ranges and the remat recompute's; the backward has none
    assert seen["step"] == 1 and seen["head"] == 2
    assert seen["attention"] == seen["moe.route"] == 4


def test_phases_of_each_block(traced_moe):
    cfg, _, rec, _ = traced_moe
    n = cfg.num_layers
    got = collections.Counter((o.name, o.phase) for o in rec.spans)
    for name in ("attention", "ffn"):
        for phase in (spans.FORWARD, spans.RECOMPUTE, spans.BACKWARD):
            assert got[name, phase] == n, (name, phase)
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert got[name, spans.FORWARD] == got[name, spans.RECOMPUTE] == n
        assert got[name, spans.BACKWARD] == 0
    assert got["head", spans.FORWARD] == got["head", spans.BACKWARD] == 2
    assert got["step", spans.FORWARD] == 1 and len(got) == 17
    assert rec.spans[0].name == "step" and rec.spans[0].host_start == 0.0
    for o in rec.spans:
        assert 0.0 <= o.host_start <= o.host_end <= rec.spans[0].host_end
        assert o.device_start is None and o.device_end is None
    # each recompute lies inside a backward occurrence of ``ffn``
    backs = [o for o in rec.spans
             if o.name == "ffn" and o.phase == spans.BACKWARD]
    for o in rec.spans:
        if o.phase == spans.RECOMPUTE:
            assert any(b.host_start <= o.host_start <= o.host_end
                       <= b.host_end for b in backs), o


def test_moe_counters_match_a_direct_count(traced_moe):
    cfg, _, rec, direct = traced_moe
    n, m = cfg.num_layers, cfg.moe
    forward = [c for in_backward, c in direct if not in_backward]
    assert len(forward) == n and len(direct) == 2 * n
    assert rec.counters["moe.pairs_kept"] == sum(forward)
    cap = moe.moe_capacity(cfg, S)
    assert rec.counters["moe.slots"] == n * B * m.num_experts * cap
    assert rec.counters["moe.pairs"] == n * B * S * m.top_k
    assert 0 < rec.counters["moe.pairs_kept"] <= rec.counters["moe.pairs"]


def test_record_holds_the_latest_window_only():
    _, job, batch = _job("h2o-danube-3-4b", "ddp")
    _step(job, batch, traced=True)
    first = spans.record()
    params, opt = job.init(0)
    job.step(params, opt, batch)              # no profiler between them
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            spans.count("n", 3)
            spans.count("n", torch.tensor(4))
    rec = spans.record()
    assert rec is not first and rec is spans.record()
    assert [o.name for o in rec.spans] == ["outer"]
    assert rec.counters == {"n": 7}
    got = collections.Counter((o.name, o.phase) for o in first.spans)
    # no remat: a dense block's layers run forward and backward only
    assert got["attention", spans.RECOMPUTE] == 0
    assert got["attention", spans.FORWARD] == got["attention",
                                                  spans.BACKWARD] > 0
    assert "moe.route" not in {o.name for o in first.spans}


@pytest.mark.parametrize("window", [0, 1000])
def test_attention_block_counters(window):
    """One blockwise forward at S 4096, chunks 512, under the profiler:
    36 of 64 block pairs visited without a window, 21 with one; the
    recompute of a checkpointed forward inside its backward adds
    nothing."""
    from repro_torch.models.blockwise import blockwise_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4096, n, 8), generator=g, requires_grad=True)
               for n in (2, 1, 1))
    attn = lambda *a: blockwise_attention(*a, window=window)
    spans.record()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.utils.checkpoint.checkpoint(attn, q, k, v,
                                          use_reentrant=False).sum().backward()
    got = spans.record().counters
    # window 1000: q blocks 0, 1 and 2 see 1, 2 and 3 kv blocks, the
    # other five 3 each
    assert got["attention.blocks"] == 64
    assert got["attention.blocks_run"] == (21 if window else 36)
