"""attention_block_use.train: the share of (q block, kv block) pairs
that blockwise attention visited over the profiled window's forwards:
the program's counters ``attention.blocks_run`` over
``attention.blocks``.  Causal attention at S 4096 in blocks of 512
visits 36 of 64 pairs; a sliding window below S visits fewer."""
from saturn_bench.spans_read import counter_ratio


def read(run):
    return counter_ratio(run, "attention.blocks_run", "attention.blocks")
