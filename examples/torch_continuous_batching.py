"""Continuous-batching serving on the PyTorch port: requests with random
lengths and staggered arrivals stream through a fixed slot pool; the
engine interleaves chunk-1 prefill with decode at token granularity,
each slot at its own cache position, as
``examples/continuous_batching.py`` runs it on the JAX package.

    PYTHONPATH=src python examples/torch_continuous_batching.py --arch gemma3-4b

--device cuda (the default) serves on the first card; --device cpu on
the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import ContinuousBatchingEngine, Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_model(cfg, seed=0, device=dev)
    eng = ContinuousBatchingEngine(cfg, params, slots=args.slots,
                                   max_len=args.max_len, device=dev)
    rng = np.random.RandomState(0)
    total_toks = 0
    for i in range(args.requests):
        plen = int(rng.randint(4, 24))
        gen = int(rng.randint(4, 16))
        total_toks += plen + gen
        eng.submit(Request(rid=i, prompt=rng.randint(
            0, cfg.vocab_size, plen).tolist(), max_new_tokens=gen))
    done = eng.run()
    th = eng.throughput()
    print(f"{cfg.name}: {th['requests']} requests, {th['tokens']} generated "
          f"tokens in {th['steps']} engine steps "
          f"(sequential would take ~{total_toks} steps)")
    print(f"mean latency {th['mean_latency_s']:.2f}s  "
          f"mean TTFT {th['mean_ttft_s']:.2f}s")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output[:8]}...")


if __name__ == "__main__":
    main()
