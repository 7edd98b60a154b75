"""The port stands alone and never drifts to the CPU: no module of
src/repro_torch (nor chip_smoke.py) imports jax or repro, the package
imports with jax unavailable, and every entry point raises when it is
left at device="cuda" on a machine without a card."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_port  # noqa: F401  (thread cap)
from repro_torch.configs import concrete_batch, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.slstm_step import slstm_step_scan
from repro_torch.kernels.ops import kernel_opts
from repro_torch.models.params import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import (init_decode_state, init_model,
                                            model_spec)
from repro_torch.models.params import init_params
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.profile import measure_serve_step_time
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallelism.build import BuiltJob
from repro_torch.parallelism.techniques import DEFAULT_TECHNIQUES
from repro_torch.core import (ClusterSpec, Job, LocalTorchBackend,
                              ProcessTorchBackend, SaturnSession,
                              TrialRunner, hardware_from_device)
from repro_torch.core.executor import LocalRunner
from repro_torch.core.library import ParallelismLibrary

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


def test_no_port_file_imports_jax_or_repro():
    assert len(PORT_FILES) > 20
    bad = {str(p.relative_to(ROOT)): m for p in PORT_FILES
           for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")}
    assert not bad, bad


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.serving.engine, repro_torch.train.steps\n"
            "import repro_torch.kernels.ops, repro_torch.configs\n"
            "import repro_torch.launch.train, repro_torch.parallelism.build\n"
            "import repro_torch.checkpoint.store, repro_torch.core.library\n"
            "import repro_torch.data.synthetic, repro_torch.optim.adamw\n"
            "import repro_torch.core, repro_torch.core.executor\n"
            "import repro_torch.core.local_backend, repro_torch.core.lns\n"
            "import repro_torch.core.process_backend\n"
            "import repro_torch.train.process_worker\n"
            "import repro_torch.core.portfolio, repro_torch.core.profiler\n"
            "import repro_torch.data.traffic, repro_torch.serving.fleet\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})


def _cfg():
    return get_config("gemma3-4b").reduced()


def _job():
    return Job("j", get_config("xlstm-125m").reduced(), 1, 4, 2)


def _session_run(backend):
    sess = SaturnSession(ClusterSpec(nodes=1, gpus_per_node=1))
    sess.submit([_job()])
    sess.profile(mode="napkin", strategy="exhaustive")
    return sess.run(backend=backend)


ENTRY_POINTS = {
    "init_params": lambda: init_params(model_spec(_cfg()), 0),
    "init_model": lambda: init_model(_cfg()),
    "params_from_numpy": lambda: params_from_numpy(
        params_to_numpy(init_model(_cfg(), device="cpu"))),
    "concrete_batch": lambda: concrete_batch(_cfg(), 1, 4),
    "init_decode_state": lambda: init_decode_state(_cfg(), 1, 4),
    "kernel_opts": lambda: kernel_opts(),
    "engine": lambda: ContinuousBatchingEngine(
        _cfg(), init_model(_cfg(), device="cpu"), slots=1, max_len=8),
    "measure_serve_step_time": lambda: measure_serve_step_time(
        get_config("recurrentgemma-2b"), slots=1, max_len=8, new_tokens=2),
    "SyntheticLM.batches": lambda: SyntheticLM(_cfg()).batches(1, 4),
    "BuiltJob": lambda: BuiltJob(_cfg(), DEFAULT_TECHNIQUES[0].plan(
        _cfg(), 1), AdamWConfig()),
    "launch.train": lambda: launch_train.main([
        "--arch", "xlstm-125m", "--reduced", "--technique", "ddp",
        "--devices", "1", "--steps", "1"]),
    "TrialRunner.profile(empirical)": lambda: TrialRunner(
        ParallelismLibrary()).profile(_job(), "ddp", 1, mode="empirical"),
    "LocalTorchBackend.bind": lambda: LocalTorchBackend().bind(
        [_job()], {}, ClusterSpec(nodes=1, gpus_per_node=1)),
    "ProcessTorchBackend.bind": lambda: ProcessTorchBackend().bind(
        [_job()], {}, ClusterSpec(nodes=1, gpus_per_node=1)),
    "SaturnSession.run(local)": lambda: _session_run("local"),
    "SaturnSession.run(process)": lambda: _session_run("process"),
    "LocalRunner.run_job": lambda: LocalRunner().run_job(
        _job(), DEFAULT_TECHNIQUES[0], 1),
    "hardware_from_device": lambda: hardware_from_device(),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_cpu_is_explicit():
    assert kernel_opts("cpu") == {}
    assert kernel_opts(torch.device("cpu")) == {}
    assert init_decode_state(_cfg(), 1, 4, device="cpu")["pos"].device.type \
        == "cpu"


def test_flash_attention_refuses_other_devices():
    q = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("kernel", ["mlstm_chunk", "slstm_step_scan",
                                    "rglru_scan"])
def test_recurrent_kernels_refuse_other_devices(kernel):
    x = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "mlstm_chunk":
            mlstm_chunk(x, x, x, x[..., 0], x[..., 0])
        elif kernel == "rglru_scan":
            rglru_scan(x[..., 0], x[..., 0])
        else:
            r = torch.empty(2, 32, 32, device="meta")
            slstm_step_scan(torch.empty(1, 8, 2, 32, 4, device="meta"),
                            r, r, r, r)
