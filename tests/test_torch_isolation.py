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
from repro_torch.kernels.slstm_step import slstm_step_scan
from repro_torch.kernels.ops import kernel_opts
from repro_torch.models.params import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import (init_decode_state, init_model,
                                            model_spec)
from repro_torch.models.params import init_params
from repro_torch.serving.engine import ContinuousBatchingEngine

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
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})


def _cfg():
    return get_config("gemma3-4b").reduced()


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


@pytest.mark.parametrize("kernel", ["mlstm_chunk", "slstm_step_scan"])
def test_recurrent_kernels_refuse_other_devices(kernel):
    x = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "mlstm_chunk":
            mlstm_chunk(x, x, x, x[..., 0], x[..., 0])
        else:
            r = torch.empty(2, 32, 32, device="meta")
            slstm_step_scan(torch.empty(1, 8, 2, 32, 4, device="meta"),
                            r, r, r, r)
