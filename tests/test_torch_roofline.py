"""The Trial Runner's roofline strategy and analytic mode in the port
(src/repro_torch/core/profiler.py on launch/step_analysis.py), against
the JAX package's.

- ``profile_all(mode="napkin", strategy="roofline")`` on
  ``bench_profile``'s job set (``hpo_grid`` of xlstm-125m and gemma3-4b,
  lrs 1e-4 and 1e-3, B 16 and 32, S 512, counts 1-32, the A100 spec)
  equals the JAX package's bit for bit: every Profile, the fitted
  calibration and ``roofline_stats``; and it meets the benchmark's
  gates (at least 20x fewer real trials than exhaustive profiling, a
  median held-out step-time error of at most 0.15).
- The cases of tests/test_roofline.py that read no HLO, on the port.
- The analytic mode on a reduced xLSTM: every technique's prediction
  scales from an analysis at its own count (``hlo_base_n == n``: a fake
  process group hosts any count, where the JAX package on one device
  scales every count from n = 1); a second profile_all analyses nothing
  new; ``TrialRunner.profile`` and ``SaturnSession.profile`` with their
  defaults return; no process group is left.
- The analytic mode counts every layer: on olmoe-1b-7b reduced to 2 and
  4 scanned layers, the port's analytic flops equal the JAX package's
  loop-aware ``analyze()`` within 2%, while the JAX analytic mode's
  flops (``compiled.cost_analysis()``) barely move with the trip count.

No case takes a wall-clock budget or a thread pool of more than one
worker: the reference's test_roofline_analytic_mode_uses_compiled_hlo
is intermittent (ROADMAP C).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch.distributed as dist

import _torch_port  # noqa: F401  (thread cap)
from repro.configs import get_config as jax_get_config
from repro.core.job import Job as JJob
from repro.core.job import hpo_grid as jax_hpo_grid
from repro.core.library import ParallelismLibrary as JLibrary
from repro.core.profiler import HARDWARE as JHARDWARE
from repro.core.profiler import TrialRunner as JTrialRunner
from repro_torch.configs import get_config
from repro_torch.core.api import SaturnSession
from repro_torch.core.job import ClusterSpec, DeviceClass, Job, hpo_grid
from repro_torch.core.library import ParallelismLibrary
from repro_torch.core.perfmodel import ObservedProfiles, PerfModel
from repro_torch.core.profiler import (CACHE_VERSION, HARDWARE,
                                       PROFILE_STRATEGIES, ClassCalibration,
                                       TrialRunner, fit_calibration,
                                       hardware_from_device)

CFG = get_config("xlstm-125m")
COUNTS = list(range(1, 17))
BENCH_MODELS = ("xlstm-125m", "gemma3-4b")
BENCH_COUNTS = list(range(1, 33))
FLOPS_RTOL = 0.02
MICRO = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             name="xlstm-micro")


def _jobs(n=2):
    return [Job(name=f"j{i}", cfg=CFG, batch_size=16 * (i + 1),
                seq_len=512, total_steps=100, lr=1e-4, seed=i)
            for i in range(n)]


def _runner(**kw):
    return TrialRunner(ParallelismLibrary(), HARDWARE["a100"], **kw)


# ------------------------------------------ bench_profile against JAX

def _bench_jobs(get, grid):
    return grid([(a, get(a)) for a in BENCH_MODELS], lrs=[1e-4, 1e-3],
                batch_sizes=[16, 32], seq_len=512, total_steps=1500)


def test_napkin_roofline_equals_the_reference_and_meets_its_gates():
    jr = JTrialRunner(JLibrary(), JHARDWARE["a100"])
    want = jr.profile_all(_bench_jobs(jax_get_config, jax_hpo_grid),
                          BENCH_COUNTS, mode="napkin", strategy="roofline",
                          workers=1)
    jobs = _bench_jobs(get_config, hpo_grid)
    r = _runner()
    got = r.profile_all(jobs, BENCH_COUNTS, mode="napkin",
                        strategy="roofline", workers=1)
    assert set(got) == set(want)
    for key in want:
        assert dataclasses.asdict(got[key]) == \
            dataclasses.asdict(want[key]), key
    assert r.roofline_stats == jr.roofline_stats
    assert {k: c.to_json() for k, c in r.calibration.items()} == \
        {k: c.to_json() for k, c in jr.calibration.items()}
    # bench_profile's gates, on the port's numbers
    ex_runner = _runner()
    ex = ex_runner.profile_all(jobs, BENCH_COUNTS, mode="napkin",
                               workers=1)
    assert ex_runner.trials / max(r.trials, 1) >= 20.0
    real = got.real_anchor_keys()
    errs = [abs(got.step_time(*k) - p.step_time_s) / p.step_time_s
            for k, p in ex.items()
            if k not in real and p.feasible
            and math.isfinite(p.step_time_s)]
    assert float(np.median(errs)) <= 0.15


# -------------------------------- tests/test_roofline.py without HLO

def test_roofline_returns_perfmodel_with_full_coverage():
    r = _runner()
    pm = r.profile_all(_jobs(), COUNTS, mode="napkin", strategy="roofline")
    assert isinstance(pm, PerfModel)
    ex = _runner().profile_all(_jobs(), COUNTS, mode="napkin",
                               strategy="exhaustive")
    assert set(pm) == set(ex)
    for key, p in ex.items():
        pr = pm[key]
        assert pr.feasible == p.feasible
        assert pr.n_devices == p.n_devices
        assert pr.device_class == p.device_class


def test_roofline_spends_only_calibration_trials():
    r = _runner()
    r.profile_all(_jobs(), COUNTS, mode="napkin", strategy="roofline",
                  calibration_trials=2)
    assert r.trials == 2 + r.roofline_stats["escalated"]
    assert r.roofline_stats["calibration_trials"] == 2
    assert r.roofline_stats["predicted"] > 20 * r.trials


def test_roofline_prediction_accuracy_vs_exhaustive():
    r = _runner()
    pm = r.profile_all(_jobs(), COUNTS, mode="napkin", strategy="roofline")
    ex = _runner().profile_all(_jobs(), COUNTS, mode="napkin",
                               strategy="exhaustive")
    errs = [abs(pm[k].step_time_s - p.step_time_s) / p.step_time_s
            for k, p in ex.items()
            if p.feasible and math.isfinite(p.step_time_s)]
    assert float(np.median(errs)) <= 0.15


def test_roofline_profiles_are_marked_and_real_anchors_tracked():
    r = _runner()
    pm = r.profile_all(_jobs(), COUNTS, mode="napkin", strategy="roofline")
    sources = {pm[k].source for k in pm}
    assert "roofline" in sources
    real = pm.real_anchor_keys()
    # exactly the calibration (and escalation) trials are real anchors
    assert len(real) == r.trials
    for key in real:
        assert pm[key].source != "roofline"
    predicted = [k for k in pm if pm[k].source == "roofline"]
    assert predicted and all(
        0.0 <= pm[k].terms["confidence"] <= 1.0 for k in predicted)


def test_confidence_threshold_one_escalates_everything():
    r = _runner()
    jobs = _jobs(1)
    r.profile_all(jobs, [1, 2, 4], mode="napkin", strategy="roofline",
                  confidence_threshold=1.1)
    assert r.roofline_stats["predicted"] == 0
    ex = _runner().profile_all(jobs, [1, 2, 4], mode="napkin",
                               strategy="exhaustive")
    assert r.trials == len(ex)


def test_roofline_hetero_keys_and_per_class_calibration():
    classes = [DeviceClass("a100", nodes=1, gpus_per_node=8),
               DeviceClass("v100", nodes=1, gpus_per_node=8,
                           hbm_per_gpu=16e9, speed_hint=0.5)]
    r = _runner()
    pm = r.profile_all(_jobs(1), list(range(1, 9)), mode="napkin",
                       strategy="roofline", classes=classes)
    key = next(iter(pm))
    assert len(key) == 4 and key[2] in ("a100", "v100")
    assert set(r.calibration) == {"a100", "v100"}
    # the slower class must predict slower steps at the same combo
    fast = pm[("j0", "ddp", "a100", 4)]
    slow = pm[("j0", "ddp", "v100", 4)]
    assert slow.step_time_s > fast.step_time_s


def test_calibration_persists_and_skips_trials_on_reload(tmp_path):
    path = str(tmp_path / "profiles.json")
    r1 = _runner(cache_path=path)
    r1.profile_all(_jobs(1), COUNTS, mode="napkin", strategy="roofline")
    assert r1.trials > 0
    data = json.loads(open(path).read())
    assert data["version"] == CACHE_VERSION
    assert "default" in data["calibration"]
    # a fresh runner loads the fit AND the cached real profiles: zero
    # new trials on a different workload of the same class
    r2 = _runner(cache_path=path)
    assert "default" in r2.calibration
    jobs2 = [Job(name="other", cfg=CFG, batch_size=8, seq_len=256,
                 total_steps=50, lr=1e-3, seed=9)]
    r2.profile_all(jobs2, COUNTS, mode="napkin", strategy="roofline")
    assert r2.trials == r2.roofline_stats["escalated"]
    assert r2.roofline_stats["calibration_trials"] == 0


def test_old_cache_version_discarded(tmp_path):
    path = str(tmp_path / "profiles.json")
    with open(path, "w") as f:
        json.dump({"version": CACHE_VERSION - 1, "profiles": [
            {"job": "j0", "technique": "ddp", "n_devices": 1,
             "step_time_s": 1.0, "mem_per_device": 1.0, "feasible": True,
             "source": "napkin"}],
            "calibration": {"default": {
                "device_class": "default", "coef": [1, 1, 1],
                "n_points": 2, "residual": 0.0, "mode": "napkin"}}}, f)
    r = _runner(cache_path=path)
    assert not r._cache and not r.calibration


def test_calibration_roundtrip_json():
    c = ClassCalibration("a100", (0.9, 1.1, 1.0), 3, 0.05, "napkin")
    c2 = ClassCalibration.from_json(c.to_json())
    assert c2 == c
    assert c2.predict((1.0, 0.0, 0.0)) == pytest.approx(0.9)


def test_fit_calibration_scalar_and_lstsq():
    # 2 points -> scalar fit recovers a global efficiency factor
    pts = [((1.0, 0.5, 0.1), 0.8 * 1.6), ((2.0, 1.0, 0.2), 0.8 * 3.2)]
    c = fit_calibration("default", pts, "napkin")
    assert c.coef[0] == pytest.approx(0.8, rel=1e-6)
    assert c.residual < 1e-9
    # >=4 points -> full least squares recovers distinct coefficients
    rng = np.random.default_rng(0)
    true = np.array([0.7, 1.3, 2.0])
    feats = rng.uniform(0.1, 2.0, size=(8, 3))
    pts = [(tuple(f), float(f @ true)) for f in feats]
    c = fit_calibration("default", pts, "napkin")
    np.testing.assert_allclose(c.coef, true, rtol=1e-6)


def test_observed_overlay_overrides_roofline():
    pm = _runner().profile_all(_jobs(1), COUNTS, mode="napkin",
                               strategy="roofline")
    key = next(k for k in pm if pm[k].source == "roofline")
    obs = ObservedProfiles(pm, {key: 123.0})
    assert obs[key].step_time_s == 123.0
    assert obs[key].source == "observed"
    other = next(k for k in pm if k != key)
    assert obs[other] == pm[other]


def test_unknown_strategy_names_all_strategies():
    with pytest.raises(ValueError) as e:
        _runner().profile_all(_jobs(1), [1, 2], strategy="nope")
    for s in PROFILE_STRATEGIES:
        assert s in str(e.value)


def test_unknown_device_class_raises():
    with pytest.raises(ValueError, match="unknown device class"):
        _runner()._class_hw("h900")


def test_hardware_from_device_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        hardware_from_device("cpu")


# ------------------------------------------------- the analytic mode

def _tiny():
    return Job(name="tiny", cfg=CFG.reduced(), batch_size=4, seq_len=32,
               total_steps=10, lr=1e-4, seed=0)


def test_analytic_roofline_analyses_every_count_as_its_own_group():
    r = _runner()
    pm = r.profile_all([_tiny()], [1, 2], mode="analytic",
                       strategy="roofline", calibration_trials=1,
                       confidence_threshold=0.0, workers=1)
    preds = [pm[k] for k in pm if pm[k].source == "roofline"]
    techs = {p.technique for p in preds}
    assert {"ddp", "fsdp", "tp", "remat-offload"} <= techs
    for p in preds:
        assert p.terms["hlo_base_n"] == float(p.n_devices)
        assert p.step_time_s > 0 and math.isfinite(p.step_time_s)
    # the n = 2 analyses saw the collectives of their techniques
    assert all(p.terms["collective_bytes"] > 0 for p in preds
               if p.n_devices == 2)
    assert r.roofline_stats["calibration_trials"] == 1
    assert not dist.is_initialized()
    assert set(r.analysis_wall_s) == set(r._analysis_cache)


def test_analysis_memoized_across_calls():
    r = _runner()
    r.profile_all([_tiny()], [1], mode="analytic", strategy="roofline",
                  confidence_threshold=0.0, workers=1)
    n = len(r._analysis_cache)
    assert n >= 1
    r.profile_all([_tiny()], [1], mode="analytic", strategy="roofline",
                  confidence_threshold=0.0, workers=1)
    assert len(r._analysis_cache) == n


def test_default_profiles_return_without_a_card():
    r = _runner()                       # device="cuda", on a CPU host
    p = r.profile(_tiny(), "ddp", 1)    # mode="analytic"
    assert p.source == "analytic" and p.feasible
    assert p.step_time_s > 0 and p.mem_per_device > 0
    # from the step's analysis: its memory is the analysis's peak
    (a,) = r._analysis_cache.values()
    assert p.mem_per_device == a["peak_bytes"]
    assert p.terms["hlo_flops"] == a["flops"]
    sess = SaturnSession(ClusterSpec(nodes=1, gpus_per_node=2),
                         device="cpu")
    cfg = dataclasses.replace(CFG.reduced(), **MICRO)
    sess.submit([Job(f"j{i}", cfg, 2, 32, total_steps=10, lr=lr, seed=i)
                 for i, lr in enumerate([1e-3, 3e-4])])
    pm = sess.profile()
    assert isinstance(pm, PerfModel)
    assert pm.step_time("j0", "ddp", 2) > 0
    # every analytic anchor came from an analysis of its own step
    runner = sess.runner
    anchors = [pm[k] for k in pm if pm[k].source == "analytic"]
    assert anchors
    for p in anchors:
        plan = runner.library.get(p.technique).plan(cfg, p.n_devices)
        key = runner._shape_key(sess.jobs[0], p.technique, plan.mesh_shape)
        assert key in runner.analysis_wall_s
    assert not dist.is_initialized()


def test_analytic_mode_counts_every_layer():
    """olmoe-1b-7b reduced to 2 and 4 layers (one scanned group, trip
    count 2 and 4), B 4 x S 32, ddp x1."""
    port, jax_analyze, jax_analytic = {}, {}, {}
    for layers in (2, 4):
        jcfg = jax_get_config("olmoe-1b-7b").reduced(num_layers=layers)
        cfg = get_config("olmoe-1b-7b").reduced(num_layers=layers)
        jr = JTrialRunner(JLibrary(), JHARDWARE["a100"])
        jjob = JJob("a", jcfg, 4, 32, 10)
        jax_analyze[layers] = jr._hlo_analysis(
            jjob, JLibrary().get("ddp").plan(jcfg, 1))["flops"]
        jax_analytic[layers] = jr.profile(
            jjob, "ddp", 1, mode="analytic").terms["hlo_flops"]
        port[layers] = _runner().profile(
            Job("a", cfg, 4, 32, 10), "ddp", 1).terms["hlo_flops"]
    for layers in (2, 4):
        assert port[layers] == pytest.approx(jax_analyze[layers],
                                             rel=FLOPS_RTOL)
    grown = port[4] - port[2]          # two more layers, counted
    assert grown == pytest.approx(jax_analyze[4] - jax_analyze[2],
                                  rel=FLOPS_RTOL)
    assert jax_analytic[4] < port[4] - 0.9 * grown
    assert abs(jax_analytic[4] - jax_analytic[2]) < 0.1 * grown


@pytest.mark.parametrize("strategy", ["exhaustive", "roofline"])
def test_a_step_that_cannot_be_analysed_raises(monkeypatch, strategy):
    """The analytic mode and the roofline strategy never stand the
    napkin model in for a failed analysis: the failure reaches the
    caller, and no profile is cached."""
    import repro_torch.core.profiler as profiler

    def broken(*args, **kw):
        raise RuntimeError("no analysis")

    monkeypatch.setattr(profiler, "analyze_train_step", broken)
    r = _runner()
    with pytest.raises(RuntimeError, match="no analysis"):
        r.profile_all([_tiny()], [1], mode="analytic", strategy=strategy,
                      calibration_trials=1, confidence_threshold=0.0,
                      workers=1)
    assert not r._analysis_cache
    assert not dist.is_initialized()


def test_threads_analyse_a_shared_step_once(monkeypatch):
    """Two shape-identical jobs profiled on a thread pool: the thread
    that asks for a step the other is analysing waits for that result
    instead of repeating it."""
    import repro_torch.core.profiler as profiler
    calls = []

    def counted(*args, **kw):
        calls.append(args[1].technique)
        return analyze(*args, **kw)

    analyze = profiler.analyze_train_step
    monkeypatch.setattr(profiler, "analyze_train_step", counted)
    r = _runner()
    jobs = [dataclasses.replace(_tiny(), name=n) for n in ("a", "b")]
    r.profile_all(jobs, [1], mode="analytic", strategy="exhaustive",
                  workers=2)
    assert sorted(calls) == ["ddp", "remat-offload"]
    assert r.trials == 4
