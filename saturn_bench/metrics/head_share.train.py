"""head_share.train: the share of the profiled window's ``step`` stream
time charged to the program's ``head`` spans (forward, recompute and
backward), each instant to the innermost span open at it
(``saturn_bench/spans_read.py``)."""
from saturn_bench.spans_read import step_share


def read(run):
    return step_share(run, "head")
