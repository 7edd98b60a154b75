"""Loop-aware counting in the port's step analyzer
(src/repro_torch/models/scan.py, src/repro_torch/launch/step_analysis.py)
against a full replay.

On ``meta`` tensors the analyzer runs four trips of each time loop and
charges the rest; the oracle is ``StepCounter`` on real CPU tensors,
which replays every trip.  For every covered loop the two give the same
flops, bytes written, collective payloads and records by op (the
``top_writers`` and ``collective_details`` rows, counts included)
exactly, and the same peak of live bytes within ``PEAK_ATOL``:

- the xlstm-125m train step (reduced to 4 layers, B 2) under ``ddp`` and
  ``remat-offload`` at S 1, 2, 3, 17 and 64: the plain sLSTM loop under
  autograd, with and without remat's recompute, and the quadratic mLSTM;
- the same step with the batched-gradient sLSTM scan (its forward scan,
  the recompute in its backward and its reverse loop);
- a no-grad prefill of the same model through ``return_state``;
- ``mlstm_chunked`` at S 1024 (chunk 256, four chunks: every trip runs)
  and at chunk 64 (16 chunks: charged), with and without autograd;
- ``blockwise_attention`` at S 2048 with reduced gemma3-4b's heads,
  window 0, 1024 and 300, at its 512-wide chunks (every trip runs), at
  256-wide ones (8 x 8: the unmasked kv blocks charged), at unequal
  chunks, and at 512 x 64 (the masked kv blocks charged too), with and
  without autograd; its flops are those of the loop over every block
  times the share of block pairs its counters report visited.

The number of ops the analyzer dispatches for the reduced xLSTM train
step is the same at S 1024 and S 2048 (both take the chunked mLSTM), and
``peak_top`` still groups the live bytes at the peak, the charged trips
as one group.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_port  # noqa: F401  (thread cap)
from _torch_all_blocks import all_blocks_attention
from repro_torch import spans
from repro_torch.configs import concrete_batch, get_config
from repro_torch.launch import step_analysis as S
from repro_torch.models.blockwise import blockwise_attention, mlstm_chunked
from repro_torch.models.params import (ShapeDtype, tree_leaves_with_paths,
                                       tree_map)
from repro_torch.models.transformer import init_model, prefill_forward
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallelism.build import BuiltJob
from repro_torch.parallelism.techniques import DEFAULT_TECHNIQUES
from torch.utils._python_dispatch import _disable_current_modes

PEAK_ATOL = 4
SEQS = [1, 2, 3, 17, 64]
B = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ALL = 10 ** 6          # rows: every group
XLSTM = get_config("xlstm-125m").reduced(num_layers=4)


def replay(fn, args):
    """The oracle: ``fn(*args)`` on real tensors under ``StepCounter``,
    every trip of every loop run."""
    counter = S.StepCounter()
    for _, x in tree_leaves_with_paths(args):
        if isinstance(x, torch.Tensor):
            counter.track(x)
    with counter:
        fn(*args)
    got = counter.result()
    got["writers"] = S._top(counter.writers, ALL)
    got["payloads"] = S._top(counter.payloads, ALL)
    return got


def shapes(args):
    return tree_map(lambda x: ShapeDtype(tuple(x.shape), x.dtype)
                    if isinstance(x, torch.Tensor) else x, args)


def analysis(fn, args):
    """The analyzer on meta tensors of ``args``' shapes."""
    got = S.analyze_step(fn, args, writers_top=ALL)
    got["writers"] = got.pop("top_writers")
    got["payloads"] = S.collective_details(fn, args, ALL)
    return got


def held(real, meta):
    for key in ("flops", "bytes_written", "collectives", "writers",
                "payloads"):
        assert meta[key] == real[key], key
    assert abs(meta["peak_bytes"] - real["peak_bytes"]) <= PEAK_ATOL, \
        (meta["peak_bytes"], real["peak_bytes"])


def technique(name):
    return [t for t in DEFAULT_TECHNIQUES if t.name == name][0]


def train_counts(tech, seq, opts=None):
    """(the replay, the analysis) of one train step of reduced xLSTM."""
    plan = technique(tech).plan(XLSTM, 1)
    built = BuiltJob(XLSTM, plan, AdamWConfig(**OPT), device="cpu",
                     opts=opts)
    params, opt = built.init(0)
    batch = concrete_batch(XLSTM, B, seq, device="cpu")
    real = replay(lambda p, o, b: built.step(p, o, built.place_batch(b)),
                  (params, opt, batch))

    def step(p, o, b):
        with _disable_current_modes():
            job = BuiltJob(XLSTM, plan, AdamWConfig(**OPT), device=S.META,
                           opts=opts)
        return job.step(p, o, job.place_batch(b))

    meta = analysis(step, S.train_step_inputs(XLSTM, plan, B, seq))
    return real, meta


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("tech", ["ddp", "remat-offload"])
def test_a_train_step_counts_as_its_full_replay(tech, seq):
    held(*train_counts(tech, seq))


@pytest.mark.parametrize("seq", SEQS)
def test_the_batched_gradient_scan_counts_as_its_full_replay(seq):
    held(*train_counts("ddp", seq, opts={"slstm_batched_grad": True}))


@pytest.mark.parametrize("seq", SEQS)
def test_a_prefill_counts_as_its_full_replay(seq):
    params = init_model(XLSTM, 0, device="cpu")
    batch = concrete_batch(XLSTM, B, seq, device="cpu")

    def prefill(p, b):
        with torch.no_grad():
            return prefill_forward(p, XLSTM, b, opts={})

    held(replay(prefill, (params, batch)),
         analysis(prefill, shapes((params, batch))))


def _tensors(seed, *dims):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(d).astype(np.float32))
                 for d in dims)


def _with_grad(fn):
    """``fn`` on its inputs made leaves that need a gradient, then the
    backward of its sum."""
    def run(*args):
        args = [a.detach().requires_grad_() for a in args]
        fn(*args).float().sum().backward()
    return run


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


@pytest.mark.parametrize("grad", [True, False], ids=["train", "prefill"])
@pytest.mark.parametrize("chunk", [256, 64])
def test_the_chunked_mlstm_counts_as_its_full_replay(chunk, grad):
    b, s, h, d = 2, 1024, 4, 32
    args = _tensors(0, (b, s, h, d), (b, s, h, d), (b, s, h, d), (b, s, h),
                    (b, s, h))
    fn = _with_grad(lambda *a: mlstm_chunked(*a, chunk=chunk)) if grad \
        else _no_grad(lambda *a: mlstm_chunked(*a, chunk=chunk,
                                                return_final=True))
    held(replay(fn, args), analysis(fn, shapes(args)))


def _block_use(fn, args) -> tuple:
    """The counters ``attention.blocks_run`` and ``attention.blocks`` of
    ``fn(*args)`` under the CPU profiler."""
    spans.record()                # the next count opens a fresh window
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*args)
    got = spans.record().counters
    return got["attention.blocks_run"], got["attention.blocks"]


@pytest.mark.parametrize("grad", [True, False], ids=["train", "prefill"])
@pytest.mark.parametrize("chunks", [512, 256, (256, 512), (512, 256),
                                    (512, 64)],
                         ids=lambda c: str(c) if isinstance(c, int)
                         else f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("window", [0, 1024, 300])
def test_blockwise_attention_counts_as_its_full_replay(window, chunks,
                                                      grad):
    """At 512 x 512 every loop runs whole; elsewhere the unmasked run of
    kv blocks is charged, and at 512 x 64 the masked blocks on the
    diagonal (and at window 300 those at the window's edge) too.  The
    flops are the all-blocks loop's times the share of pairs the
    counters say were visited."""
    cfg = get_config("gemma3-4b").reduced()
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qc, kc = (chunks, chunks) if isinstance(chunks, int) else chunks
    args = _tensors(1, (1, 2048, h, d), (1, 2048, kv, d), (1, 2048, kv, d))
    kw = dict(window=window, q_chunk=qc, kv_chunk=kc)
    attn = lambda q, k, v: blockwise_attention(q, k, v, **kw)
    every = lambda q, k, v: all_blocks_attention(q, k, v, **kw)
    wrap = _with_grad if grad else _no_grad
    meta = analysis(wrap(attn), shapes(args))
    held(replay(wrap(attn), args), meta)
    run, blocks = _block_use(_no_grad(attn), args)
    assert blocks == (2048 // qc) * (2048 // kc) and 0 < run < blocks
    full = analysis(wrap(every), shapes(args))
    assert meta["flops"] * blocks == full["flops"] * run


def test_a_train_steps_dispatched_ops_do_not_grow_with_the_length():
    """At S 1024 and 2048 both xLSTM loops are long (the mLSTM takes
    the chunked form above S 512), and the analyzer dispatches the same
    ops for each; the flops double."""
    plan = technique("ddp").plan(XLSTM, 1)
    at = {s: S.analyze_train_step(XLSTM, plan, AdamWConfig(**OPT), B, s)
          for s in (1024, 2048)}
    assert at[1024]["dispatched_ops"] == at[2048]["dispatched_ops"]
    assert at[2048]["flops"] == pytest.approx(2 * at[1024]["flops"],
                                              rel=0.01)


def test_peak_top_groups_the_bytes_of_charged_trips():
    """A no-grad chunked mLSTM of 16 chunks peaks while its output list
    holds every chunk: the charged chunks' outputs are one group, and
    the groups add up to the peak."""
    args = shapes(_tensors(2, *[(1, 1024, 2, 16)] * 3, (1, 1024, 2),
                           (1, 1024, 2)))
    fn = _no_grad(lambda *a: mlstm_chunked(*a, chunk=64))
    got = S.analyze_step(fn, args, peak_top=1000)
    assert sum(g[0] for g in got["at_peak"]) == got["peak_bytes"]
    charged = [g for g in got["at_peak"] if g[2] == "charged loop trips"]
    assert len(charged) == 1 and charged[0][0] > 0
