"""moe_dispatch_share.train: the share of the MoE FFN's stream time (its
four spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine``, forward and recompute) charged to ``moe.dispatch``."""
from saturn_bench.spans_read import moe_share


def read(run):
    return moe_share(run, "moe.dispatch")
