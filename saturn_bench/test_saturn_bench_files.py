"""Every file BENCHMARK.json names loads, and every name and unit keeps
to the benchmark's rules."""
import json
import os
import re

import pytest

from saturn_bench import cells, check

BENCH = cells.benchmark()
HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_names(bench: dict) -> list:
    """What in ``bench`` breaks the contract's rules for names and
    units (empty where nothing does)."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            for key in ("name", "config", "traffic"):
                if key in entry and not NAME.match(entry[key]):
                    bad.append(f"{group}: {key} {entry[key]!r}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                bad.append(f"{group}: unit {entry['unit']!r}")
            for key in entry.get("reduced", ()):
                if not NAME.match(key):
                    bad.append(f"{group}: reduced {key!r}")
    return bad


def test_names_and_units():
    assert check_names(BENCH) == []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "saturn_bench/run.py"]
    assert BENCH["paths"] == ["saturn_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    config = cells.load_json(os.path.join(cells.ROOT, entry["file"]))
    assert config["name"] == entry["name"]
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    assert config["source"].startswith(entry["source"])
    cfg = cells.model_config(config)
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import model_spec
    assert param_count(model_spec(cfg)) == config["parameters"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_file(entry):
    cell = cells.load_cell(entry["name"])
    tr = cell.traffic
    assert tr["limits"] and set(tr["limits"]) <= set(check.NAMES)
    assert tr["tokens"] == "uniform" and tr["ring"] > tr["checked_steps"]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert tr["probe"]["choice"] == {"technique": tr["technique"],
                                     "batch": tr["batch"]}


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_reader(entry):
    assert callable(cells.reader(entry["name"]))
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert os.path.exists(os.path.join(HERE, "metrics",
                                       entry["name"] + ".py"))


def test_files_named_from_name_characters():
    for base, _, files in os.walk(HERE):
        for f in files:
            if "__pycache__" in base:
                continue
            rel = os.path.relpath(os.path.join(base, f), cells.ROOT)
            assert all(c.isalnum() or c in "_.-/" for c in rel), rel
            assert json.dumps(rel).isascii()
