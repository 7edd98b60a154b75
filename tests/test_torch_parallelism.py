"""The port's multi-device techniques (src/repro_torch/parallelism/) on
gloo ranks on the CPU, held against the JAX package's one-device step.

Each case spawns its ranks once (``repro_torch.parallelism.dist.spawn``,
one torch thread a rank) and runs every technique in its search
space inside that one spawn: h2o-danube-3-4b and olmoe-1b-7b reduced to
4 layers at N 4, xlstm-125m reduced to 4 layers at N 2, all five
techniques each (the reference's own test runs N 8, where the reduced
configs' 4 heads and 4 layers keep ``tp`` and ``gpipe`` out of the
space).  The weights are the JAX init with wq, wk and wv rescaled
(tests/test_torch_families.py says why); the batch is
``concrete_batch`` (B 8 x S 32) and the optimizer parallel_check's
(lr 1e-3, one warm-up step).  One step on N ranks against the JAX
one-device step on the same numpy batch: loss and grad_norm (and the
other metrics) at rtol 1e-5, the parameters and AdamW's mu and nu at
tests/test_torch_families.py's PARAM_ATOL 5e-4.  The reference's
contract (loss and every parameter within 2e-2) runs once more on the
raw init, at h2o-danube-3-4b x4, where AdamW's first step moves elements
whose gradients cancel to ~1e-9 by up to 2 lr whichever way their last
ulp falls (ROADMAP C5's mechanism; the reference measures 2.0e-3 there).

Beside them, tp x4 of internvl2-1b reduced, whose 2 kv heads do not
divide over 4 ranks, and tp x2 of recurrentgemma-2b reduced (the
RG-LRU's gates, conv and decay split by rnn channel, and its two layer
groups).  Around the techniques: remat's recompute across two layer
groups (a closure that picked up the last group's parameters broke
remat-offload for every config with a remainder group); fsdp x4's
resident parameter + mu + nu bytes on every rank (the solver's
``memory_fraction``), and each rank's peak bytes in the step and in the
checkpoint's gather; a checkpoint written by fsdp x2 resumed under
ddp x1 and under tp x2, each continuing within the parity bounds of a
straight JAX run, and loading in the JAX package's store;
``launch.train`` under a two-rank gloo ``torchrun``; and the
reference's ``test_plan_shapes`` and ``test_gpipe_search_space_rules``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (thread cap)
from _torch_port import np32
from test_torch_model import _rescale
from repro.checkpoint.store import _flatten_with_paths
from repro.checkpoint.store import load_checkpoint as jax_load_checkpoint
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint.store import load_training_state, save_checkpoint
from repro_torch.configs import concrete_batch, get_config
from repro_torch.models.params import (param_count, params_from_numpy,
                                       params_to_numpy,
                                       tree_leaves_with_paths)
from repro_torch.models.transformer import model_spec
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.parallelism.base import largest_divisible_axis
from repro_torch.parallelism.build import BuiltJob
from repro_torch.parallelism.dist import spawn
from repro_torch.parallelism.techniques import (DDP, DEFAULT_TECHNIQUES,
                                                RematOffload)
from repro_torch.testing.parallel_check import segments, technique_runs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"h2o-danube-3-4b": 4, "olmoe-1b-7b": 4, "xlstm-125m": 2}
TECHNIQUES = [t.name for t in DEFAULT_TECHNIQUES]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S = 8, 32
RTOL = 1e-5
PARAM_ATOL = 5e-4
CONTRACT_TOL = 2e-2
CONTRACT_ARCH = "h2o-danube-3-4b"
SPAWN_TIMEOUT_S = 240.0


def _cfgs(arch):
    return (jax_get_config(arch).reduced(num_layers=4),
            get_config(arch).reduced(num_layers=4))


def _batch(jcfg, key=None):
    return {k: np.asarray(v)
            for k, v in jax_concrete_batch(jcfg, B, S, key=key).items()}


def _jstep(jcfg):
    return jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**OPT)))


class Runs:
    """Each case's spawn, made on first use: its ranks run every
    technique from the rescaled init (and, for CONTRACT_ARCH, from the
    raw one too); beside them the JAX one-device steps from the same
    parameters on the same batch."""

    def __init__(self):
        self._done = {}

    def __call__(self, arch):
        if arch not in self._done:
            self._done[arch] = self._run(arch)
        return self._done[arch]

    @staticmethod
    def _run(arch):
        n = CASES[arch]
        jcfg, cfg = _cfgs(arch)
        raw = jt.init_model(jcfg, jax.random.PRNGKey(1))
        inits = {"rescaled": _rescale(jcfg, raw)}
        if arch == CONTRACT_ARCH:
            inits["raw"] = raw
        batch = _batch(jcfg)
        names = [t.name for t in DEFAULT_TECHNIQUES
                 if t.search_space(cfg, n)]
        # the peaks are read where fsdp's 1/N matters (N 4)
        got = spawn(technique_runs, ["cpu"] * n, cfg, AdamWConfig(**OPT),
                    {k: _flatten_with_paths(p) for k, p in inits.items()},
                    batch, names, ("rescaled",) if n == 4 else (),
                    timeout_s=SPAWN_TIMEOUT_S)
        jstep = _jstep(jcfg)
        refs = {k: jstep(p, jax_init_opt_state(p), batch)
                for k, p in inits.items()}
        return {"n": n, "cfg": cfg, "names": names, "got": got,
                "refs": refs}


@pytest.fixture(scope="module")
def runs():
    return Runs()


def _close(got, want_tree, atol, what):
    want = _flatten_with_paths(want_tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=f"{what}/{k}")


@pytest.mark.parametrize("arch", list(CASES))
def test_every_technique_is_in_the_search_space(runs, arch):
    """tp and gpipe included: the reduced configs' 4 heads, 4 experts and
    4 layers divide over N."""
    assert runs(arch)["names"] == TECHNIQUES


@pytest.mark.parametrize("technique", TECHNIQUES)
@pytest.mark.parametrize("arch", list(CASES))
def test_technique_matches_jax_one_device_step(runs, arch, technique):
    case = runs(arch)
    r = case["got"]["rescaled"][technique]
    jp, jo, jm = case["refs"]["rescaled"]
    m = r["metrics"]
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k], np32(jm[k]), rtol=RTOL, atol=0,
                                   err_msg=k)
    assert r["step"] == int(jo["step"]) == 1
    _close(r["params"], jp, PARAM_ATOL, "params")
    _close(r["mu"], jo["mu"], PARAM_ATOL, "mu")
    _close(r["nu"], jo["nu"], PARAM_ATOL, "nu")


def _tp_against_jax(arch, n):
    """One tp x``n`` step of ``arch`` reduced against the JAX one-device
    step at the stated bounds."""
    jcfg, cfg = _cfgs(arch)
    jparams = _rescale(jcfg, jt.init_model(jcfg, jax.random.PRNGKey(1)))
    batch = _batch(jcfg)
    got = spawn(technique_runs, ["cpu"] * n, cfg, AdamWConfig(**OPT),
                {"rescaled": _flatten_with_paths(jparams)}, batch, ["tp"],
                timeout_s=SPAWN_TIMEOUT_S)["rescaled"]["tp"]
    jp, jo, jm = _jstep(jcfg)(jparams, jax_init_opt_state(jparams), batch)
    for k in jm:
        np.testing.assert_allclose(got["metrics"][k], np32(jm[k]),
                                   rtol=RTOL, atol=0, err_msg=k)
    _close(got["params"], jp, PARAM_ATOL, "params")
    _close(got["mu"], jo["mu"], PARAM_ATOL, "mu")
    _close(got["nu"], jo["nu"], PARAM_ATOL, "nu")


def test_tp_with_kv_heads_that_do_not_divide():
    """internvl2-1b reduced (4 heads, 2 kv heads, a vision-embeds prefix)
    at tp x4: the kv heads stay replicated, each rank attends with its q
    heads' kv columns, and their gradients are summed over the ranks;
    one step against the JAX one-device step at the same bounds."""
    cfg = get_config("internvl2-1b").reduced(num_layers=4)
    assert cfg.num_kv_heads % 4 and cfg.num_heads % 4 == 0
    _tp_against_jax("internvl2-1b", 4)


def test_tp_splits_the_rglru_by_rnn_channel():
    """recurrentgemma-2b reduced (a scanned rglru, rglru, swa repeat and
    an unrolled rglru; 4 heads, 1 kv head) at tp x2, the count its full
    config's 10 heads admit below 5: the RG-LRU's gates are
    reduce-split over the rnn channels, its conv and decay cut by
    channel, and w_out row-split with its partial sums reduced; one step
    against the JAX one-device step at the same bounds."""
    cfg = get_config("recurrentgemma-2b").reduced(num_layers=4)
    assert [m for m, _, _ in cfg.layer_plan()] == ["scan", "unroll"]
    tp = next(t for t in DEFAULT_TECHNIQUES if t.name == "tp")
    assert tp.search_space(cfg, 2)
    assert tp.search_space(get_config("recurrentgemma-2b"), 2)
    _tp_against_jax("recurrentgemma-2b", 2)


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_reference_contract_on_the_raw_init(runs, technique):
    case = runs(CONTRACT_ARCH)
    r = case["got"]["raw"][technique]
    jp, _, jm = case["refs"]["raw"]
    loss = r["metrics"]["loss"]
    assert abs(loss - float(jm["loss"])) < CONTRACT_TOL
    want = _flatten_with_paths(jp)
    diff = max(float(np.max(np.abs(r["params"][k] - want[k])))
               for k in want)
    assert diff < CONTRACT_TOL


@pytest.mark.parametrize("arch", [a for a, n in CASES.items() if n == 4])
def test_fsdp_rests_a_quarter_of_the_state_on_each_rank(runs, arch):
    """fsdp x4: each rank's resident params + mu + nu are 1/4 of the
    one-device total, plus the leaves with no dim divisible by 4, which
    stay whole (the solver plans with memory_fraction 1/4)."""
    case = runs(arch)
    cfg, n = case["cfg"], case["n"]
    want, whole = 0, 0
    for _, spec in tree_leaves_with_paths(model_spec(cfg)):
        size = int(np.prod(spec.shape))
        if largest_divisible_axis(spec.shape, n) is None:
            whole += size
            want += size
        else:
            want += size // n
    want *= 3 * 4                       # params, mu, nu in float32
    total = 3 * 4 * param_count(model_spec(cfg))
    for tech in ("fsdp", "remat-offload"):
        assert case["got"]["rescaled"][tech]["resident_bytes"] == [want] * n
    assert want == pytest.approx(total / n + 3 * 4 * whole * (1 - 1 / n))
    assert want < 0.26 * total
    assert case["got"]["rescaled"]["ddp"]["resident_bytes"] == [total] * n


@pytest.mark.parametrize("arch", [a for a, n in CASES.items() if n == 4])
def test_fsdp_holds_one_unit_whole_at_a_time(runs, arch):
    """fsdp x4 and remat-offload x4 (fsdp with remat), P being the
    one-device parameter bytes.  Beyond its resident quarter, a rank's
    step holds its gradient parts, one unit (a layer, the embedding)
    whole at a time with its gradient and the collectives' buffers, and
    the activations: 1.1-1.45 P here with the profiler's allocations
    (parallel_check.peak_bytes), up to 0.3 P more under load, where
    gloo's threads free some collective buffers late or out of the
    profiler's sight.  Gathering the tree up front held it whole with
    its flat buffer, the whole gradients and a flat copy: at least 4 P
    by count.  So the bound is 2 P.  A checkpoint's gather holds
    nothing on ranks 1-3; on rank 0 it holds one leaf's parts beside
    the host copy of the tree (3 P: parameters, mu, nu), which shares
    the CPU's memory here; gathering every tree onto every rank held
    the trees whole on each, with their flat buffers."""
    case = runs(arch)
    cfg, n = case["cfg"], case["n"]
    p_bytes = 4 * param_count(model_spec(cfg))
    leaf = max(4 * int(np.prod(s.shape))
               for _, s in tree_leaves_with_paths(model_spec(cfg)))
    for tech in ("fsdp", "remat-offload"):
        r = case["got"]["rescaled"][tech]
        for rank, step in enumerate(r["step_peak_bytes"]):
            assert 0 < step < 2 * p_bytes, (tech, rank, step / p_bytes)
        commit = r["commit_peak_bytes"]
        assert commit[0] <= 3 * p_bytes + 2 * leaf, \
            (tech, commit[0] / p_bytes)
        assert all(c <= leaf / n for c in commit[1:]), (tech, commit)


def test_checkpoint_crosses_techniques_and_packages(tmp_path):
    """fsdp x2 writes the reference's full-tree npz after one step; it
    resumes under ddp x1 (in this process, no group) and under tp x2,
    and each second step matches two straight JAX steps; the file loads
    in the JAX package's store as the same tree."""
    arch = "xlstm-125m"
    jcfg, cfg = _cfgs(arch)
    jparams = _rescale(jcfg, jt.init_model(jcfg, jax.random.PRNGKey(1)))
    b1, b2 = _batch(jcfg, key=1), _batch(jcfg, key=2)
    jstep = _jstep(jcfg)
    jp1, jo1, _ = jstep(jparams, jax_init_opt_state(jparams), b1)
    jp2, jo2, jm2 = jstep(jp1, jo1, b2)

    params = params_from_numpy(_flatten_with_paths(jparams), device="cpu")
    init, ck1, ck_tp = (str(tmp_path / f) for f in
                        ("init.npz", "fsdp2.npz", "tp2.npz"))
    save_checkpoint(init, {"params": params, "opt": init_opt_state(params)},
                    {"step": 0})
    opt_cfg = AdamWConfig(**OPT)
    m_fsdp, m_tp = spawn(segments, ["cpu"] * 2, cfg, opt_cfg,
                         [("fsdp", init, ck1, b1), ("tp", ck1, ck_tp, b2)],
                         timeout_s=SPAWN_TIMEOUT_S)

    # the JAX package reads the sharded job's checkpoint
    like = {"params": jparams, "opt": jax_init_opt_state(jparams)}
    jtree = jax_load_checkpoint(ck1, like)
    _close(params_to_numpy(load_training_state(
        ck1, params, init_opt_state(params))[0]), jtree["params"], 0.0,
        "jax-loaded")
    _close(params_to_numpy(load_training_state(
        ck1, params, init_opt_state(params))[0]), jp1, PARAM_ATOL, "step 1")

    job = BuiltJob(cfg, DDP().plan(cfg, 1), opt_cfg, device="cpu")
    p, o = job.init(0)
    p, o, start = job.load(ck1, p, o)
    assert start == 1 and int(o["step"]) == 1
    p, o, m = job.step(p, o, job.place_batch(
        {k: torch.as_tensor(np.array(v)) for k, v in b2.items()}))
    np.testing.assert_allclose(float(m["loss"]), float(jm2["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(m_tp["loss"], float(jm2["loss"]), rtol=RTOL)
    np.testing.assert_allclose(m_tp["grad_norm"], float(jm2["grad_norm"]),
                               rtol=RTOL)
    _close(params_to_numpy(p), jp2, PARAM_ATOL, "ddp x1")
    p_tp, o_tp, start = load_training_state(ck_tp, params,
                                            init_opt_state(params))
    assert start == 2 and int(o_tp["step"]) == 2
    _close(params_to_numpy(p_tp), jp2, PARAM_ATOL, "tp x2")
    _close(params_to_numpy(o_tp["mu"]), jo2["mu"], PARAM_ATOL, "tp x2 mu")
    assert m_fsdp["loss"] > 0


def test_launch_train_under_two_rank_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train`` on the
    CPU: two gloo ranks train fsdp x2; rank 0 prints and writes the
    full-tree checkpoint, which a one-device job loads."""
    ck = tmp_path / "ck.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "xlstm-125m", "--technique", "fsdp", "--steps", "2",
         "--batch", "4", "--seq", "32", "--reduced", "--device", "cpu",
         "--log-every", "1", "--ckpt", str(ck)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum("fsdp x2 devices" in ln for ln in lines) == 1
    assert sum(ln.startswith("step ") for ln in lines) == 2
    cfg = get_config("xlstm-125m").reduced()
    job = BuiltJob(cfg, DDP().plan(cfg, 1), AdamWConfig(), device="cpu")
    p, o = job.init(0)
    _, o, start = job.load(str(ck), p, o)
    assert start == 2 and int(o["step"]) == 2


def test_remat_recomputes_each_layer_group_with_its_own_params():
    """recurrentgemma-2b reduced to 4 layers has two layer groups (a
    scanned repeat of rglru, rglru, swa and an unrolled rglru).  Remat
    recomputes a unit during the backward, after the forward has moved
    on to the next group, and must use its own group's parameters: one
    remat-offload step equals the ddp step, bit for bit."""
    cfg = get_config("recurrentgemma-2b").reduced(num_layers=4)
    assert [m for m, _, _ in cfg.layer_plan()] == ["scan", "unroll"]
    batch = concrete_batch(cfg, 2, 16, device="cpu")
    out = {}
    for tech in (DDP(), RematOffload()):
        job = BuiltJob(cfg, tech.plan(cfg, 1), AdamWConfig(**OPT),
                       device="cpu")
        p, o = job.init(0)
        p, _, m = job.step(p, o, batch)
        out[tech.name] = (params_to_numpy(p), float(m["loss"]))
    (pa, la), (pb, lb) = out["ddp"], out["remat-offload"]
    assert la == lb
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_remat_recompute_runs_under_its_forward_rules(monkeypatch):
    """On a CUDA device autograd runs the backward, and with it a remat
    recompute, on a thread of its own, where the caller's axis rules
    are not set.  Each block must still see the rules of its forward:
    here the backward runs from another thread."""
    import threading

    from repro_torch.models import transformer as T
    from repro_torch.parallelism.context import axis_rules, current_rules
    cfg = get_config("recurrentgemma-2b").reduced(num_layers=4)
    params = T.tree_map(lambda t: t.requires_grad_(True),
                        T.init_model(cfg, 0, device="cpu"))
    batch = concrete_batch(cfg, 2, 16, device="cpu")
    seen, failed = [], []
    block = T._block_apply

    def spy(*args, **kwargs):
        seen.append(current_rules())
        return block(*args, **kwargs)
    monkeypatch.setattr(T, "_block_apply", spy)
    rules = {"batch": None, "seq": None}
    with axis_rules(rules, None):
        logits, _ = T.forward(params, cfg, batch, remat=True)
    n_forward = len(seen)

    def backward():
        try:
            logits.float().sum().backward()
        except Exception as e:  # noqa: BLE001 (raised below, on this thread)
            failed.append(e)
    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert not failed, failed
    assert n_forward == 4 and len(seen) == 2 * n_forward
    assert all(r is rules for r in seen)
    assert current_rules() is None


def test_plan_shapes():
    cfg = get_config("h2o-danube-3-4b")
    for t in DEFAULT_TECHNIQUES:
        if t.search_space(cfg, 8):
            plan = t.plan(cfg, 8)
            assert int(np.prod(plan.mesh_shape)) == 8
            assert 0 < t.memory_fraction(cfg, 8) <= 1.0
            assert t.step_overhead() >= 1.0


def test_gpipe_search_space_rules():
    from repro_torch.parallelism.techniques import GPipe
    g = GPipe()
    assert g.search_space(get_config("h2o-danube-3-4b"), 4)   # 24 % 4 == 0
    assert not g.search_space(get_config("h2o-danube-3-4b"), 5)
    assert not g.search_space(get_config("gemma3-4b"), 4)  # remainder layers
    # 26 = 8 pattern repeats + 2 remainder layers -> not pipelineable
    assert not g.search_space(get_config("recurrentgemma-2b"), 2)
    assert g.search_space(get_config("qwen3-moe-235b-a22b"), 2)  # 94 % 2
