"""The PyTorch port's examples (``examples/torch_*.py``), each beside
its JAX package counterpart, run as a user first meets them: in a
subprocess, on the CPU (``--device cpu``), at small flags, each under
its own timeout.  Each must exit 0 and print its lines, and neither
``jax`` nor the JAX package (``repro``, or a ``repro.`` module) may be
loaded in the child when it exits.  With ``--device cuda`` and no card
an example raises.  The two profiling examples run at their default
flags in files of their own (``test_torch_example_quickstart.py``,
``test_torch_example_model_selection.py``); here each is loaded.
"""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs an example as __main__, then names the reference modules loaded
RUNNER = textwrap.dedent("""
    import runpy, sys
    path = sys.argv[1]
    sys.argv = sys.argv[1:]
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        ref = sorted(m for m in sys.modules
                     if m in ("jax", "repro")
                     or m.startswith(("jax.", "repro.")))
        print("REFERENCE_MODULES=" + ",".join(ref), flush=True)
""")


# loads an example as a module (its main not run), then does the same
LOADER = textwrap.dedent("""
    import runpy, sys
    got = runpy.run_path(sys.argv[1], run_name="example")
    print("MAIN=" + str(callable(got.get("main"))))
    ref = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    print("REFERENCE_MODULES=" + ",".join(ref), flush=True)
""")


def run_example(name, args, timeout, tmp_path, env=None):
    out = subprocess.run(
        [sys.executable, "-c", RUNNER,
         os.path.join(ROOT, "examples", name)] + args,
        capture_output=True, text=True, timeout=timeout, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="2", **(env or {})))
    return out


def check(out):
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "REFERENCE_MODULES=", lines[-1]
    return lines[:-1]


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_model_selection.py"])
def test_a_profiling_example_loads_only_the_port(tmp_path, name):
    """Each profiling example, loaded as a module, defines ``main``
    with neither ``jax`` nor the JAX package loaded."""
    out = subprocess.run(
        [sys.executable, "-c", LOADER, os.path.join(ROOT, "examples", name)],
        capture_output=True, text=True, timeout=60, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert check(out) == ["MAIN=True"]


def test_torch_train_e2e(tmp_path):
    lines = check(run_example(
        "torch_train_e2e.py",
        ["--device", "cpu", "--gpus", "1", "--steps", "4", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")], 180, tmp_path))
    assert "== Trial Runner (empirical, real minibatches) ==" in lines
    assert any(ln.endswith(" ms/step") and "xlstm-12m-lr" in ln
               for ln in lines)
    assert "== Solver + LocalTorchBackend (real training, checkpointed) ==" \
        in lines
    assert any(ln.lstrip().startswith("makespan ") and "replans=" in ln
               for ln in lines)
    done = [ln for ln in lines if " steps in " in ln and "loss " in ln]
    assert len(done) == 2
    for ln in done:
        assert int(ln.split(": ")[1].split()[0]) >= 4


def test_torch_serve_batch(tmp_path):
    lines = check(run_example(
        "torch_serve_batch.py",
        ["--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen",
         "4"], 120, tmp_path))
    assert lines[0] == "arch=gemma3-4b-smoke batch=2"
    assert lines[1].startswith("prompt warm-up: ")
    assert "decode: 3 steps in " in lines[1] and lines[1].endswith(" tok/s)")
    assert lines[2].startswith("generated ids (row 0): [")


def test_torch_continuous_batching(tmp_path):
    lines = check(run_example(
        "torch_continuous_batching.py",
        ["--device", "cpu", "--requests", "3", "--slots", "2"], 120,
        tmp_path))
    assert lines[0].startswith("gemma3-4b-smoke: 3 requests, ")
    assert "engine steps (sequential would take ~" in lines[0]
    assert lines[1].startswith("mean latency ") and "mean TTFT " in lines[1]
    assert [ln.split(":")[0] for ln in lines[2:]] == \
        ["  req 0", "  req 1", "  req 2"]


@pytest.mark.parametrize("name", ["torch_serve_batch.py",
                                  "torch_continuous_batching.py",
                                  "torch_train_e2e.py"])
def test_an_example_raises_without_a_card(tmp_path, name):
    """Without a card (``CUDA_VISIBLE_DEVICES`` empty) the default
    ``--device cuda`` raises; nothing drifts to the CPU."""
    out = run_example(name, [], 60, tmp_path,
                      env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
