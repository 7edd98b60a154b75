"""device_idle_share.train: the share of the profiled window in which no
kernel, copy or fill runs on the device (rank 0's)."""
from saturn_bench.trace import length


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - length(run.trace.busy()) / run.trace.window_s)
