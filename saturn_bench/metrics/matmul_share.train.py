"""matmul_share.train: the share of the device's busy time in the
profiled window in which a matrix-product kernel runs, by kernel name
(gemm, xmma, cutlass, cublas).  The rest is routing, dispatch, softmax,
the loss and the optimizer."""
from saturn_bench.trace import MATMUL, length


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * length(run.trace.busy(MATMUL.search)) \
        / length(run.trace.busy())
