"""moe_slot_use.train: the share of the experts' slab rows that hold a
kept (token, k) pair, over the profiled window's forwards: the program's
counters ``moe.pairs_kept`` over ``moe.slots``.  Capacity 1.25 bounds
it by 80%."""
from saturn_bench.spans_read import counter_ratio


def read(run):
    return counter_ratio(run, "moe.pairs_kept", "moe.slots")
