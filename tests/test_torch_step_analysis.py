"""The port's step analyzer (src/repro_torch/launch/step_analysis.py)
against the JAX package's compiled-HLO analyzer
(src/repro/launch/hlo_analysis.py) and against real gloo ranks.

- The framework-neutral functions (``collective_link_factor``,
  ``link_seconds``, ``scale_analysis``) equal the reference's bit for bit
  on a grid of kinds, counts and payloads drawn with numpy from a seed,
  and the reference's own cases that read no HLO text pass on the port.
- Flops: the one-device ``ddp`` train step of reduced gemma3-4b,
  olmoe-1b-7b, xlstm-125m and recurrentgemma-2b (4 layers, B 4 x S 32),
  lowered as the reference's ``TrialRunner._compiled_step`` lowers it,
  against ``analyze()`` of its HLO: within 2%.  Three are equal; the
  xLSTM differs by exactly the four recurrent matvecs a sLSTM layer's
  scan transpose runs at t = 0 for the initial carry's cotangent
  (dh_0 = sum over the gates of d_pre R), which autograd skips because
  h_0 needs no gradient.
- Collectives: every technique of h2o-danube-3-4b reduced at N 4 and of
  xlstm-125m reduced at N 2, analysed as rank 0 of a fake group, counts
  the collective payloads by kind and the flops that the same counting
  mode reads on rank 0 of a real gloo group (``parallelism.dist.spawn``)
  exactly, and the peak of live bytes within one fp32 scalar.  The bytes written differ by
  the reduce-scatter payload alone: gloo's reduce-scatter lands its
  result with an ``aten.copy_`` that the dispatcher sees, where NCCL
  and the fake group write it inside the collective.  For ``ddp`` the
  all-reduce payload is the fp32 gradient bytes plus the two fp32
  metrics (loss, aux loss) averaged with them.
- No default group is left after an analysis, and an analysis inside
  an existing group raises.
"""
import datetime
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_port  # noqa: F401  (thread cap)
from repro.configs import get_config as jax_get_config
from repro.core.job import Job as JJob
from repro.core.library import ParallelismLibrary as JLibrary
from repro.core.profiler import TrialRunner as JTrialRunner
from repro.launch import hlo_analysis as H
from repro_torch.configs import concrete_batch, get_config
from repro_torch.launch import step_analysis as S
from repro_torch.models.params import param_count, tree_leaves_with_paths
from repro_torch.models.transformer import model_spec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallelism.build import BuiltJob
from repro_torch.parallelism.dist import spawn
from repro_torch.parallelism.techniques import DDP, DEFAULT_TECHNIQUES

B, SEQ, LAYERS = 4, 32, 4
FLOPS_RTOL = 0.02
FLOPS_ARCHS = ["gemma3-4b", "olmoe-1b-7b", "xlstm-125m", "recurrentgemma-2b"]
GROUP_CASES = {"h2o-danube-3-4b": 4, "xlstm-125m": 2}
GROUP_B, GROUP_S = 4, 16
# the first step a process traces can hold one fp32 scalar a moment
# longer at its peak than later steps do (a first-call effect inside
# PyTorch), so peaks of a fresh process are held to 4 bytes
PEAK_ATOL = 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


# ------------------------------------------ the framework-neutral functions

def test_neutral_functions_equal_the_reference():
    rng = np.random.default_rng(0)
    kinds = list(S.KNOWN_COLLECTIVES) + ["all-reduce-start",
                                         "all-gather-start",
                                         "ragged-all-to-all", "broadcast"]
    for n in (1, 2, 3, 4, 8, 16, 64, 512):
        for kind in kinds:
            assert S.collective_link_factor(kind, n) == \
                H.collective_link_factor(kind, n)
        for _ in range(8):
            picked = rng.choice(kinds, size=rng.integers(1, 4),
                                replace=False)
            coll = {str(k): float(v) for k, v in
                    zip(picked, rng.uniform(0, 1e9, len(picked)))}
            coll["total"] = sum(coll.values())
            bw = float(rng.uniform(1e9, 1e12))
            assert S.link_seconds(coll, n, bw) == H.link_seconds(coll, n, bw)
            a = {"flops": float(rng.uniform(0, 1e15)),
                 "bytes_written": float(rng.uniform(0, 1e12)),
                 "collectives": coll}
            to = int(rng.integers(1, 64))
            for ws in (True, False):
                assert S.scale_analysis(a, n, to, work_scales=ws) == \
                    H.scale_analysis(a, n, to, work_scales=ws)


def test_unknown_collective_kind_is_unfit():
    secs, unfit = S.link_seconds({"ragged-all-to-all": 1e6, "total": 1e6},
                                 8, 1e9)
    assert unfit == ["ragged-all-to-all"]
    assert secs > 0      # still charged conservatively at 1x


def test_link_factor_units():
    f = S.collective_link_factor
    assert f("all-reduce", 4) == 2.0 * 3 / 4
    assert f("all-gather", 4) == 3 / 4
    assert f("reduce-scatter", 8) == 7 / 8
    assert f("collective-permute", 8) == 1.0
    assert f("all-reduce", 1) == 0.0
    assert f("all-reduce-start", 4) == f("all-reduce", 4)
    assert f("ragged-all-to-all", 4) is None


def test_scale_analysis_work_and_payload():
    a = {"flops": 8e9, "bytes_written": 4e9,
         "collectives": {"all-reduce": 1e6, "total": 1e6}}
    s = S.scale_analysis(a, 2, 8)
    assert s["flops"] == 2e9                  # same work over 4x devices
    assert s["bytes_written"] == 1e9
    assert s["collectives"]["all-reduce"] == 1e6   # payload constant
    assert (s["scaled_from"], s["scaled_to"]) == (2.0, 8.0)
    f = S.scale_analysis(a, 2, 8, work_scales=False)
    assert f["flops"] == 8e9


# ------------------------------------------------------- flops at n = 1

def jax_hlo_analysis(arch, num_layers=LAYERS):
    """(analyze() of the compiled one-device ddp step, its
    cost_analysis() flops), lowered as the reference's Trial Runner
    lowers it: fp32 parameters and AdamW state, ``concrete_batch``."""
    jcfg = jax_get_config(arch).reduced(num_layers=num_layers)
    runner = JTrialRunner(JLibrary())
    job = JJob("a", jcfg, B, SEQ, 10)
    plan = JLibrary().get("ddp").plan(jcfg, 1)
    cost = runner._compiled_step(job, plan).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return runner._hlo_analysis(job, plan), float(cost["flops"])


def port_analysis(arch, num_layers=LAYERS):
    cfg = get_config(arch).reduced(num_layers=num_layers)
    return S.analyze_train_step(cfg, DDP().plan(cfg, 1),
                                AdamWConfig(**OPT), B, SEQ)


def slstm_t0_matvec_flops(arch, num_layers=LAYERS):
    """The flops of the matvecs the JAX scan transpose runs for the
    initial carry (4 gates a sLSTM layer, 2 B H D^2 each)."""
    cfg = get_config(arch).reduced(num_layers=num_layers)
    n_slstm = sum(kinds.count("slstm") * reps
                  for _, kinds, reps in cfg.layer_plan())
    d = cfg.d_model // cfg.num_heads
    return n_slstm * 4 * 2.0 * B * cfg.num_heads * d * d


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_flops_match_the_hlo_analysis(arch):
    want, _ = jax_hlo_analysis(arch)
    got = port_analysis(arch)
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_RTOL)
    # the one difference, named
    assert want["flops"] - got["flops"] == slstm_t0_matvec_flops(arch)
    assert got["collectives"] == {"total": 0.0}
    assert got["bytes_written"] > 0 and got["peak_bytes"] > 0


# ------------------------------------------------ collectives at n > 1

def _real_counts(group, arch, n, names):
    """On each gloo rank: every technique's step on real tensors under
    the counting mode; rank 0's counts come back."""
    cfg = get_config(arch).reduced(num_layers=4)
    out = {}
    for t in DEFAULT_TECHNIQUES:
        if t.name not in names:
            continue
        built = BuiltJob(cfg, t.plan(cfg, n), AdamWConfig(**OPT),
                         group=group)
        params, opt = built.init(0)
        batch = concrete_batch(cfg, GROUP_B, GROUP_S, device="cpu")
        counter = S.StepCounter()
        for _, x in tree_leaves_with_paths((params, opt, batch)):
            counter.track(x)
        with counter:
            built.step(params, opt, built.place_batch(batch))
        out[t.name] = counter.result()
        del params, opt
    return out


@pytest.fixture(scope="module")
def group_counts():
    runs = {}
    for arch, n in GROUP_CASES.items():
        cfg = get_config(arch).reduced(num_layers=4)
        names = [t.name for t in DEFAULT_TECHNIQUES
                 if t.search_space(cfg, n)]
        real = spawn(_real_counts, ["cpu"] * n, arch, n, names,
                     timeout_s=240.0)
        fake = {t.name: S.analyze_train_step(
                    cfg, t.plan(cfg, n), AdamWConfig(**OPT), GROUP_B,
                    GROUP_S)
                for t in DEFAULT_TECHNIQUES if t.name in names}
        runs[arch] = (names, real, fake)
    return runs


@pytest.mark.parametrize("arch", list(GROUP_CASES))
def test_fake_group_counts_equal_a_gloo_rank(group_counts, arch):
    names, real, fake = group_counts[arch]
    assert names == [t.name for t in DEFAULT_TECHNIQUES]   # all five
    for name in names:
        r, f = real[name], fake[name]
        assert f["collectives"] == r["collectives"], name
        assert f["flops"] == r["flops"], name
        assert abs(f["peak_bytes"] - r["peak_bytes"]) <= PEAK_ATOL, name
        assert r["bytes_written"] - f["bytes_written"] == \
            r["collectives"].get("reduce-scatter", 0.0), name
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", list(GROUP_CASES))
def test_ddp_all_reduces_the_gradient_and_two_metrics(group_counts, arch):
    _, _, fake = group_counts[arch]
    cfg = get_config(arch).reduced(num_layers=4)
    grads = 4.0 * param_count(model_spec(cfg))
    assert fake["ddp"]["collectives"] == {"all-reduce": grads + 2 * 4.0,
                                          "total": grads + 2 * 4.0}


# ----------------------------------------------------------- the group

def test_no_group_is_left_and_an_existing_group_is_refused(tmp_path):
    cfg = get_config("h2o-danube-3-4b").reduced()
    step = S.analyze_train_step(cfg, DDP().plan(cfg, 2), AdamWConfig(),
                                2, 8)
    assert step["collectives"]["all-reduce"] > 0
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        with pytest.raises(RuntimeError, match="already has a default"):
            S.analyze_train_step(cfg, DDP().plan(cfg, 1), AdamWConfig(),
                                 2, 8)
    finally:
        dist.destroy_process_group()


def test_analyze_step_counts_a_matmul_and_its_live_bytes():
    """A hand-checked case: (8, 16) @ (16, 32) in fp32 is 2*8*32*16
    flops and writes 8*32*4 bytes; the inputs and the output are live at
    once at the peak."""
    from repro_torch.models.params import ShapeDtype
    a = S.analyze_step(lambda x, w: x @ w,
                       (ShapeDtype((8, 16), torch.float32),
                        torch.zeros(16, 32)))
    assert a["flops"] == 2 * 8 * 32 * 16
    assert a["bytes_written"] == 8 * 32 * 4
    assert a["peak_bytes"] == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    assert a["collectives"] == {"total": 0.0}
    assert math.isfinite(a["flops"])


def test_peak_top_groups_the_bytes_live_at_the_peak():
    """At the peak both (8, 32) fp32 products and the relu of the
    second are live beside the arguments (the sum comes after the
    second product is freed).  ``at_peak`` groups them by op, shape and
    dtype, largest first, and its groups add up to the peak."""
    from repro_torch.models.params import ShapeDtype

    def fn(x, w):
        y = x @ w
        z = torch.relu(x @ w) + y
        del y
        return z * 2

    args = (ShapeDtype((8, 16), torch.float32), torch.zeros(16, 32))
    a = S.analyze_step(fn, args, peak_top=10)
    assert a["peak_bytes"] == S.analyze_step(fn, args)["peak_bytes"]
    got = {(op, shape): (n, c) for n, c, op, shape, _ in a["at_peak"]}
    assert sum(n for n, _ in got.values()) == a["peak_bytes"]
    assert [e[0] for e in a["at_peak"]] == sorted(
        (e[0] for e in a["at_peak"]), reverse=True)
    assert got[("argument", (8, 16))] == (8 * 16 * 4, 1)
    assert got[("argument", (16, 32))] == (16 * 32 * 4, 1)
    assert got[("aten.mm.default", (8, 32))] == (2 * 8 * 32 * 4, 2)
    assert got[("aten.relu.default", (8, 32))] == (8 * 32 * 4, 1)
    assert len(S.analyze_step(fn, args, peak_top=1)["at_peak"]) == 1
