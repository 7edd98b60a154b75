"""mfu.train: the model FLOPs of the measured window's steps over its
time, as a share of the cards' published float32 peak (the card's power
limit is recorded beside the numbers in PERF.md).  Arithmetic, no
trace."""


def read(run):
    if run.peak_flops is None or run.window_s <= 0:
        return None
    return 100.0 * run.model_flops / run.window_s \
        / (run.peak_flops * run.chips)
