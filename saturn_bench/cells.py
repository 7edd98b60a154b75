"""Cells, configurations, traffic and per-layer metrics, found by name.

``BENCHMARK.json`` at the checkout's root lists them.  Each lives in a
file of its own under this folder, so that a later cell adds files and
entries and edits none:

- ``configs/<config>.json``: the model's sizes (the keys of the
  program's ``ModelConfig``), its source, the keys ``reduced`` from it,
  the sizes ``assumed`` and the deployment that the cut stands for;
- ``workloads/<traffic>.json``: the job (sequence length, batch,
  technique, learning rate and schedule), how its tokens are drawn, the
  probe that chose the batch and technique, and the limits of the
  numbers that ``correct`` compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None where it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict                 # configs/<config>.json
    traffic: dict                # workloads/<traffic>.json
    chips: int
    end_to_end: List[dict]       # BENCHMARK.json's entries this cell reports
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = os.path.join(root, os.path.basename(HERE))
    return Cell(
        name=name,
        config=load_json(os.path.join(here, "configs",
                                      entry["config"] + ".json")),
        traffic=load_json(os.path.join(here, "workloads",
                                       entry["traffic"] + ".json")),
        chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if reported(m, name)])


def reader(metric: str, root: str = ROOT) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, os.path.basename(HERE), "metrics",
                        metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "saturn_bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file: its keys
    that are fields of the config, the MoE group as ``MoEConfig``."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw["block_pattern"] = tuple(kw["block_pattern"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)

