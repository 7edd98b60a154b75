"""``examples/torch_quickstart.py`` run as a user first meets it: in a
subprocess, at its default flags, under its own timeout, with neither
``jax`` nor the JAX package loaded when it exits.  It profiles its
eight jobs analytically (72 step analyses on the host CPU, each time
loop of the xLSTM jobs counted once and charged for its trips), solves
and simulates; Saturn's makespan must beat current practice's.  A file
of its own, so that ``--dist loadfile`` gives it a worker of its own.
"""
import re

from test_torch_examples import check, run_example

ASSIGNED = re.compile(r"^  \S+ +-> +\S+ x\d+ GPUs$")


def test_torch_quickstart(tmp_path):
    lines = check(run_example("torch_quickstart.py", [], 900, tmp_path))
    assert lines[:2] == ["", "jobs: 8  cluster: 8 GPUs"]
    current = re.fullmatch(r"current practice : ([0-9.]+) h", lines[2])
    saturn = re.fullmatch(
        r"saturn           : ([0-9.]+) h \((\d+)% lower, (\d+) replans\)",
        lines[3])
    assert current and saturn, lines[2:4]
    assert float(saturn.group(1)) < float(current.group(1))
    assert len(lines) == 14
    assert all(ASSIGNED.match(ln) for ln in lines[4:]), lines[4:]
