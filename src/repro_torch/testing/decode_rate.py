"""Greedy decode rate of the port's one-device serve step.

    PYTHONPATH=src python -m repro_torch.testing.decode_rate \\
        [--arch gemma3-4b olmoe-1b-7b] [--batch 4] [--length 4160] \\
        [--blocks 5] [--block-steps 16] [--device cuda|cpu] [--reduced]

For each arch (full width and depth unless ``--reduced``; random bf16
weights from seed 0) it decodes from a zeroed state of ``--length``
positions, first with one ``pos`` for every row and then with each
row's own (``init_decode_state(per_row_pos=True)``, rows spread over the
cache), through ``train.steps.make_serve_step``: one block of warm-up,
then ``--blocks`` blocks of ``--block-steps`` steps, synchronised at
each block's ends.  Prints one JSON line per arch and position kind with
each block's seconds a step, their median, and tokens a second at it.
Decode at these sizes is host-paced: compare two trees of the port in
one process run after another on one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.transformer import init_decode_state, init_model
from ..train.steps import make_serve_step


def decode_rate(arch: str, batch: int, length: int, blocks: int,
                block_steps: int, per_row: bool, device, reduced=False):
    """One arch's record (see the module's docstring)."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = init_model(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    state = init_decode_state(cfg, batch, length, dtype=torch.bfloat16,
                              per_row_pos=per_row, device=dev)
    room = length - (blocks + 1) * block_steps
    if per_row:
        start = torch.arange(batch) * room // max(batch, 1)
        state["pos"] = start.to(torch.int32).to(dev)
    else:
        state["pos"] = torch.tensor(room - 1, dtype=torch.int32,
                                    device=dev)
    serve_step = make_serve_step(cfg)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    step_s = []
    for block in range(blocks + 1):
        sync()
        t0 = time.perf_counter()
        for _ in range(block_steps):
            tok, logits, state = serve_step(params, tok, state)
        sync()
        if block:                            # block 0 is the warm-up
            step_s.append((time.perf_counter() - t0) / block_steps)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: decode logits not finite")
    med = statistics.median(step_s)
    return {"arch": cfg.name, "batch": batch, "length": length,
            "per_row": per_row, "blocks": blocks,
            "block_steps": block_steps, "step_s": step_s,
            "median_step_s": med, "tokens_per_s": batch / med,
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["gemma3-4b",
                                                  "olmoe-1b-7b"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--length", type=int, default=4160)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--block-steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config")
    args = ap.parse_args(argv)
    for arch in args.arch:
        for per_row in (False, True):
            rec = decode_rate(arch, args.batch, args.length, args.blocks,
                              args.block_steps, per_row, args.device,
                              reduced=args.reduced)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
