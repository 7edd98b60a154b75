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
  h_0 needs no gradient.  At S 1024 and 2048, where the mLSTM runs chunk
  by chunk, the difference adds the chunk loop's terms, named in
  ``mlstm_chunk_flops``: the first chunk's zero carry and the last
  chunk's unused state update, and contractions the two frameworks lay
  out differently.
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
- A scatter counts what it writes into its destination, not the
  destination, as the reference counts a dynamic-update-slice's update
  operand: one hand count for each scatter op.  One decode step of
  h2o-danube-3-4b reduced (4 layers, window 32, B 2, fp32) counts its KV
  cache writes at the token's size, so its ``bytes_written`` at L 1024
  exceeds L 64's by exactly what grows with L outside them (the
  scores, the probs, the mask and einsum's copies of the cache parts
  for its two products), and stands at 0.152 of the reference's
  ``analyze()`` of the same step at L 64 (0.217 when the writes counted
  the whole cache; the reference's fusions also write relaid weights).
- ``top_writers`` and ``collective_details``: the rows of the counter's
  record by op, sorted, summing to at most the totals, with the cache
  writes at the update's size and a tp step's all-reduce named with its
  group's size on two gloo ranks.
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
from repro_torch.models.params import (ShapeDtype, param_count,
                                       tree_leaves_with_paths)
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

def jax_hlo_analysis(arch, num_layers=LAYERS, seq=SEQ):
    """(analyze() of the compiled one-device ddp step, its
    cost_analysis() flops), lowered as the reference's Trial Runner
    lowers it: fp32 parameters and AdamW state, ``concrete_batch``."""
    jcfg = jax_get_config(arch).reduced(num_layers=num_layers)
    runner = JTrialRunner(JLibrary())
    job = JJob("a", jcfg, B, seq, 10)
    plan = JLibrary().get("ddp").plan(jcfg, 1)
    cost = runner._compiled_step(job, plan).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return runner._hlo_analysis(job, plan), float(cost["flops"])


def port_analysis(arch, num_layers=LAYERS, seq=SEQ):
    cfg = get_config(arch).reduced(num_layers=num_layers)
    return S.analyze_train_step(cfg, DDP().plan(cfg, 1),
                                AdamWConfig(**OPT), B, seq)


def slstm_t0_matvec_flops(arch, num_layers=LAYERS):
    """The flops of the matvecs the JAX scan transpose runs for the
    initial carry (4 gates a sLSTM layer, 2 B H D^2 each)."""
    cfg = get_config(arch).reduced(num_layers=num_layers)
    n_slstm = sum(kinds.count("slstm") * reps
                  for _, kinds, reps in cfg.layer_plan())
    d = cfg.d_model // cfg.num_heads
    return n_slstm * 4 * 2.0 * B * cfg.num_heads * d * d


def mlstm_chunk_flops(arch, seq, num_layers=LAYERS, chunk=256):
    """What the reference's ``analyze()`` counts beyond the port in the
    mLSTM layers where the chunked form runs (S > 512), over nc = S /
    chunk chunks of L = chunk, head dim D: the JAX scan transpose runs
    the same body every trip, autograd skips products no gradient
    needs, and the two frameworks lay some contractions out
    differently.  A layer's share, in products of 2 B H L D^2 and of
    2 B H L D flops:

    - the reference's L D^2 products: the gradient of the first chunk's
      zero C carry through h_inter (1), and of the last chunk's C update
      with respect to (w_in k) and to v (2), which the final state gets
      none of in training;
    - the reference's L D products: the gradient of the first chunk's
      zero n carry through n_inter (1) and of the last chunk's n update
      with respect to w_in (1); in every chunk the C update's gradient
      with respect to w_in, a dot over D in the reference and a multiply
      and sum in the port (nc);
    - the port's L D products, run by ``bmm`` over a contracted dim of
      1 where the reference broadcasts a multiply: n_inter's gradient
      with respect to q in every chunk (nc), and the n update's with
      respect to k in every chunk but the last (nc - 1)."""
    cfg = get_config(arch).reduced(num_layers=num_layers)
    n_mlstm = sum(kinds.count("mlstm") * reps
                  for _, kinds, reps in cfg.layer_plan())
    h = cfg.num_heads
    d = 2 * cfg.d_model // h
    nc = seq // chunk
    ldd = 2.0 * B * h * chunk * d * d
    ld = 2.0 * B * h * chunk * d
    reference = 3 * ldd + (1 + 1 + nc) * ld
    port = (nc + nc - 1) * ld
    return n_mlstm * (reference - port)


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_flops_match_the_hlo_analysis(arch):
    want, _ = jax_hlo_analysis(arch)
    got = port_analysis(arch)
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_RTOL)
    # the one difference, named
    assert want["flops"] - got["flops"] == slstm_t0_matvec_flops(arch)
    assert got["collectives"] == {"total": 0.0}
    assert got["bytes_written"] > 0 and got["peak_bytes"] > 0


@pytest.mark.parametrize("seq", [1024, 2048])
def test_xlstm_flops_match_the_hlo_analysis_with_the_chunked_mlstm(seq):
    """Above S 512 the mLSTM runs chunk by chunk (4 and 8 chunks here),
    and the reference counts the sLSTM's t = 0 matvecs and the chunk
    loop's terms of ``mlstm_chunk_flops`` beyond the port, to the
    flop."""
    arch = "xlstm-125m"
    want, _ = jax_hlo_analysis(arch, seq=seq)
    got = port_analysis(arch, seq=seq)
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_RTOL)
    assert want["flops"] - got["flops"] == \
        slstm_t0_matvec_flops(arch) + mlstm_chunk_flops(arch, seq)


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


# ------------------------------------------------ scatters and writers

def _meta_scatter(op):
    """(fn, args, bytes it writes into its destination) of each scatter
    op counted by its update: an fp32 destination (4, 8, 3)."""
    f32 = lambda *shape: ShapeDtype(shape, torch.float32)
    i64 = lambda *shape: ShapeDtype(shape, torch.int64)
    dest = f32(4, 8, 3)
    aten = torch.ops.aten
    cases = {
        # (rows, positions) picks 4 of the 32 (row, position) slots, each
        # 3 wide: values (4, 3)
        "index_put_": (lambda x, r, p, v: x.index_put_((r, p), v),
                       (dest, i64(4), i64(4), f32(4, 3)), 4 * 3 * 4),
        "_index_put_impl_": (
            lambda x, r, p, v: aten._index_put_impl_(x, [r, None, p], v),
            (dest, i64(2), i64(2), f32(2, 8)), 2 * 8 * 4),
        "index_copy_": (lambda x, i, v: x.index_copy_(1, i, v),
                        (dest, i64(2), f32(4, 2, 3)), 4 * 2 * 3 * 4),
        "index_add_": (lambda x, i, v: x.index_add_(1, i, v),
                       (dest, i64(5), f32(4, 5, 3)), 4 * 5 * 3 * 4),
        "scatter_": (lambda x, i, v: x.scatter_(1, i, v),
                     (dest, i64(4, 2, 3), f32(4, 2, 3)), 4 * 2 * 3 * 4),
        "scatter_.value": (lambda x, i: x.scatter_(1, i, 2.0),
                           (dest, i64(4, 6, 3)), 4 * 6 * 3 * 4),
        "scatter_add_": (lambda x, i, v: x.scatter_add_(1, i, v),
                         (dest, i64(4, 1, 3), f32(4, 1, 3)), 4 * 1 * 3 * 4),
        "scatter_reduce_": (
            lambda x, i, v: x.scatter_reduce_(1, i, v, "amax"),
            (dest, i64(2, 8, 3), f32(2, 8, 3)), 2 * 8 * 3 * 4),
        # on meta the mask's true count would need data: source counts
        "masked_scatter_": (
            lambda x, m, v: x.masked_scatter_(m, v),
            (dest, ShapeDtype((4, 8, 3), torch.bool), f32(7)), 7 * 4),
    }
    return cases[op]


SCATTERS = ["index_put_", "_index_put_impl_", "index_copy_",
            "index_add_", "scatter_", "scatter_.value", "scatter_add_",
            "scatter_reduce_", "masked_scatter_"]


@pytest.mark.parametrize("op", SCATTERS)
def test_a_scatter_counts_its_update_not_its_destination(op):
    fn, args, want = _meta_scatter(op)
    got = S.analyze_step(fn, args, writers_top=10)
    assert got["bytes_written"] == want
    (n, name, shape, dtype, count), = got["top_writers"]
    assert (n, shape, dtype, count) == (want, (4, 8, 3), torch.float32, 1)
    assert name.startswith("aten." + op.split(".")[0] + ".")
    # the destination stays live as before: it is an argument
    assert got["peak_bytes"] == sum(
        math.prod(a.shape) * a.dtype.itemsize for a in args)


def test_an_out_of_place_index_put_counts_the_tensor_it_makes():
    """``torch.index_put`` copies its destination into a fresh tensor
    and writes the update there: the whole new tensor counts, though
    the indexed shape (2, 8, 3) is a half of it."""
    dest = ShapeDtype((4, 8, 3), torch.float32)
    args = (dest, ShapeDtype((2,), torch.int64),
            ShapeDtype((1,), torch.float32))
    got = S.analyze_step(lambda x, r, v: torch.index_put(x, (r,), v),
                         args, writers_top=10)
    assert got["bytes_written"] == 4 * 8 * 3 * 4
    assert got["top_writers"] == [
        (4 * 8 * 3 * 4, "aten.index_put.default", (4, 8, 3),
         torch.float32, 1)]
    assert got["peak_bytes"] == sum(
        math.prod(a.shape) * a.dtype.itemsize for a in args) + 4 * 8 * 3 * 4


def test_a_masked_scatter_on_the_cpu_counts_the_masks_true_elements():
    x = torch.zeros(4, 8, 3)
    mask = torch.zeros(4, 8, 1, dtype=torch.bool)
    mask[1, 2] = mask[3, 5] = mask[0, 0] = True       # 3 x 3 broadcast
    counter = S.StepCounter()
    with counter:
        x.masked_scatter_(mask, torch.ones(20))
    assert counter.result()["bytes_written"] == 3 * 3 * 4 + 20 * 4
    assert counter.writers[("aten.masked_scatter_.default", (4, 8, 3),
                            torch.float32)] == [3 * 3 * 4, 1]


def test_a_bool_index_on_the_cpu_counts_its_true_elements():
    x = torch.zeros(6, 5)
    rows = torch.tensor([True, False, True, True, False, False])
    counter = S.StepCounter()
    with counter:
        x.index_put_((rows,), torch.ones(5))
    assert counter.writers[("aten.index_put_.default", (6, 5),
                            torch.float32)] == [3 * 5 * 4, 1]


DEC_ARCH, DEC_B, DEC_LAYERS = "h2o-danube-3-4b", 2, 4


def _decode_analysis(L, per_row=False):
    """analyze_step of one port decode step of reduced DEC_ARCH in fp32
    over caches of L, with its writers."""
    from repro_torch.models.params import ShapeDtype, tree_map
    from repro_torch.models.transformer import (decode_state_spec,
                                                decode_step)
    cfg = get_config(DEC_ARCH).reduced(num_layers=DEC_LAYERS)
    params = tree_map(lambda s: ShapeDtype(s.shape, torch.float32),
                      model_spec(cfg))
    state = tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                     decode_state_spec(cfg, DEC_B, L, torch.float32))
    if per_row:
        state["pos"] = ShapeDtype((DEC_B,), torch.int32)
    step = lambda p, t, s: decode_step(p, cfg, t, s, opts={})
    return cfg, S.analyze_step(step, (params, ShapeDtype((DEC_B, 1),
                                                         torch.int32),
                                      state), writers_top=1000)


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar-pos", "per-row-pos"])
def test_a_decode_step_writes_its_cache_at_the_tokens_size(per_row):
    """At L 64 and at L 1024 the cache writes are the same: two
    ``index_put_`` a layer of one token's k or v (B, Kv, D).  The rest
    of the difference is what each attention layer computes over L:
    einsum's contiguous copies of k and of v for the two products
    (a clone and its ``_unsafe_view``, each B Kv D L fp32), the scores,
    their masked copy and the probs (B H L fp32 each), and the mask:
    the positions (L int64, twice: arange and its offset), each row's
    distance from them (B L int64) and three (B L) bools."""
    cfg, small = _decode_analysis(64, per_row)
    _, large = _decode_analysis(1024, per_row)
    b, h, kv = DEC_B, cfg.num_heads, cfg.num_kv_heads
    d, layers = cfg.resolved_head_dim, DEC_LAYERS
    assert set(cfg.block_pattern) == {"swa"} and cfg.window_size
    for got, L in ((small, 64), (large, 1024)):
        rows = [r for r in got["top_writers"]
                if r[1] == "aten.index_put_.default"]
        assert [r[2] for r in rows] == [(b, L, kv, d)]
        assert rows[0][0] == 2 * layers * b * kv * d * 4
        assert rows[0][4] == 2 * layers
    per_l = (4 * b * kv * d * 4        # copies of k and v for einsum
             + 3 * b * h * 4           # scores, masked scores, probs
             + 2 * 8 + b * 8 + 3 * b)  # the mask
    assert large["bytes_written"] - small["bytes_written"] == \
        layers * per_l * (1024 - 64)


def test_a_decode_steps_bytes_written_against_the_reference():
    """The port's one decode step (scalar pos, L 64) against the
    reference's ``analyze()`` of its compiled ``decode_step``: 0.152 of
    it (counting every eager op, the cache writes at the token's size;
    XLA's fusions write the relaid weights and whole cache parts), with
    the flops equal."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    jcfg = jget(DEC_ARCH).reduced(num_layers=DEC_LAYERS)
    params = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
        jax.eval_shape(lambda: jt.init_model(jcfg, jax.random.PRNGKey(0))))
    state = jax.eval_shape(
        lambda: jt.init_decode_state(jcfg, DEC_B, 64, jnp.float32))
    hlo = jax.jit(lambda p, t, s: jt.decode_step(p, jcfg, t, s)).lower(
        params, jax.ShapeDtypeStruct((DEC_B, 1), jnp.int32),
        state).compile().as_text()
    want = H.analyze(hlo)
    _, got = _decode_analysis(64)
    assert got["flops"] == want["flops"]
    ratio = got["bytes_written"] / want["bytes_written"]
    assert 0.14 <= ratio <= 0.165, ratio


def test_top_writers_rows_are_the_counters_record_sorted():
    from repro_torch.models.params import ShapeDtype

    def fn(x, w, cache, v):
        y = torch.relu(x @ w) + x @ w
        cache.index_copy_(1, torch.tensor([3]), v)
        return y * 2

    args = (ShapeDtype((8, 16), torch.float32), torch.zeros(16, 32),
            ShapeDtype((8, 64, 32), torch.float32),
            ShapeDtype((8, 1, 32), torch.float32))
    rows = S.top_writers(fn, args, k=20)
    total = S.analyze_step(fn, args)["bytes_written"]
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert sum(r[0] for r in rows) == total
    got = {(op, shape): (n, c) for n, op, shape, _, c in rows}
    assert got[("aten.mm.default", (8, 32))] == (2 * 8 * 32 * 4, 2)
    assert got[("aten.index_copy_.default", (8, 64, 32))] == (8 * 32 * 4, 1)
    two = S.top_writers(fn, args, k=2)
    assert two == rows[:2] and sum(r[0] for r in two) <= total


def _tp_step_details(group):
    """On each gloo rank of two: one tp x2 train step of reduced
    h2o-danube-3-4b under the counting mode; rank 0's collective
    details and totals."""
    cfg = get_config("h2o-danube-3-4b").reduced(num_layers=2)
    plan = [t for t in DEFAULT_TECHNIQUES if t.name == "tp"][0].plan(cfg, 2)
    built = BuiltJob(cfg, plan, AdamWConfig(**OPT), group=group)
    params, opt = built.init(0)
    batch = concrete_batch(cfg, GROUP_B, GROUP_S, device="cpu")
    counter = S.StepCounter()
    with counter:
        built.step(params, opt, built.place_batch(batch))
    return {"rows": S._top(counter.payloads, 100),
            "result": counter.result()}


def test_collective_details_name_a_tp_steps_all_reduce():
    """A tp x2 step on two gloo ranks and its analysis as rank 0 of a
    fake group of two give the same rows: the all-reduces (Megatron's
    row-split outputs and their gradients) over a group of 2, sorted by
    payload and summing to the all-reduce total."""
    real = spawn(_tp_step_details, ["cpu"] * 2, timeout_s=240.0)
    cfg = get_config("h2o-danube-3-4b").reduced(num_layers=2)
    plan = [t for t in DEFAULT_TECHNIQUES if t.name == "tp"][0].plan(cfg, 2)
    from torch.utils._python_dispatch import _disable_current_modes

    def step(params, opt, batch):
        with _disable_current_modes():
            built = BuiltJob(cfg, plan, AdamWConfig(**OPT), device=S.META,
                             group=S.current_group())
        return built.step(params, opt, built.place_batch(batch))

    rows = S.collective_details(
        step, S.train_step_inputs(cfg, plan, GROUP_B, GROUP_S), k=100,
        world_size=2)
    assert not dist.is_initialized()
    assert rows == real["rows"]
    kinds = {r[1] for r in rows}
    assert "all-reduce" in kinds
    assert all(r[4] == 2 for r in rows)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    by_kind = {}
    for n, kind, *_ in rows:
        by_kind[kind] = by_kind.get(kind, 0) + n
    coll = real["result"]["collectives"]
    assert by_kind == {k: v for k, v in coll.items() if k != "total"}
    assert S.collective_details(
        step, S.train_step_inputs(cfg, plan, GROUP_B, GROUP_S), k=1,
        world_size=2) == rows[:1]
