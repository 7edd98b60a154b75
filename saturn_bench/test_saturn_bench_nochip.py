"""Without a card a run exits non-zero and prints no result; nothing
the benchmark runs loads JAX or the JAX package; the reference loads
nothing of the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from saturn_bench import cells

ROOT = cells.ROOT
WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "PYTHONPATH"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.mark.parametrize("name", WORKLOADS)
def test_no_card_no_result(name, no_cuda, tmp_path):
    proc = subprocess.run(
        [sys.executable, "saturn_bench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, env=_clean_env(), timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_program_no_result(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "saturn_bench"),
                    tmp_path / "saturn_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = _clean_env()
    env.pop("CUDA_VISIBLE_DEVICES")
    proc = subprocess.run(
        [sys.executable, "saturn_bench/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, env=_clean_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    code = (
        "import json, sys; sys.path[:0] = ['.', 'src'];\n"
        "import saturn_bench.run, saturn_bench.drive, saturn_bench.calibrate,"
        " saturn_bench.probe, saturn_bench.reference.train\n"
        "from saturn_bench import cells\n"
        "b = cells.benchmark()\n"
        "[cells.load_cell(w['name']) for w in b['workloads']]\n"
        "[cells.reader(m['name']) for m in b['per_layer']]\n"
        "[cells.model_config(cells.load_json(cells.ROOT + '/' + c['file']))"
        " for c in b['configs']]\n"
        "import saturn_bench.drive as d; d._job(cells.load_cell("
        "b['workloads'][0]['name']), 1, 'cpu')\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in %r)))" % (FORBIDDEN,))
    assert _loaded(code) == []


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path[:0] = ['.'];\n"
            "import saturn_bench.reference.train\n"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('repro_torch',) + %r)))" % (FORBIDDEN,))
    assert _loaded(code) == []
