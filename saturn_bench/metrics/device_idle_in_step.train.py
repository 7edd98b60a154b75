"""device_idle_in_step.train: the share of the profiled window in which
the device is idle (no kernel, copy or fill) while the host is inside a
``step`` range of the program: the idle that the step's own host work
leaves, read from the trace's one clock alone."""
from saturn_bench.spans_read import STEP
from saturn_bench.trace import length, subtract, union


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    w = run.trace.window_s
    steps = union([(s, e) for s, e, n in run.trace.host if n == STEP])
    if not steps:
        return None
    idle = subtract([(0.0, w)], run.trace.busy())
    outside = subtract([(0.0, w)], steps)
    return 100.0 * length(subtract(idle, outside)) / w
