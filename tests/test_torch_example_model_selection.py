"""``examples/torch_model_selection.py`` run as a user first meets it:
in a subprocess, at its default flags (the wikitext workload, 12 jobs on
8 GPUs, flat placement, offline), under its own timeout, with neither
``jax`` nor the JAX package loaded when it exits.  It profiles the jobs
analytically on the host CPU (each time loop of the xLSTM jobs counted
once and charged for its trips), runs every policy and prints Saturn's
Gantt; Saturn's makespan must be the lowest.  A file of its own, so
that ``--dist loadfile`` gives it a worker of its own.
"""
import re

from test_torch_examples import check, run_example

POLICIES = ["current-practice", "random", "optimus", "optimus-dynamic",
            "saturn"]
ROW = re.compile(r"^  (\S+) +([0-9.]+) h   util=([0-9.]+) replans=(\d+) "
                 r"restarts=(\d+)$")
SEGMENT = re.compile(r"^  t= *[0-9.]+h\.\. *[0-9.]+h  \S+ +\S+ x\d+ "
                     r"gpus=[0-9,\-]+$")


def test_torch_model_selection(tmp_path):
    lines = check(run_example("torch_model_selection.py", [], 900,
                              tmp_path))
    assert lines[0] == "wikitext: 12 jobs, 8 GPUs, flat placement, offline"
    rows = [ROW.match(ln) for ln in lines[1:6]]
    assert all(rows), lines[1:6]
    hours = {m.group(1): float(m.group(2)) for m in rows}
    assert list(hours) == POLICIES
    assert hours["saturn"] == min(hours.values())
    gantt = lines.index("Saturn Gantt (first 12 segments) — note the mixed "
                        "parallelisms/allocations:")
    assert lines[6:gantt] == [""]
    assert lines[gantt + 1:] and all(SEGMENT.match(ln)
                                     for ln in lines[gantt + 1:]), \
        lines[gantt + 1:]
