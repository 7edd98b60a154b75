"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

- the program against the reference on each seed (the lower readings);
- the control on the first three seeds: the reference computed with
  TF32 products, the precision below the configuration's float32, in
  the program's place;
- each fault of ``faults.FAULTS`` planted in the program on the first
  three seeds (``unchanged`` reads 1 by construction and is not run).

    python3 saturn_bench/calibrate.py --workload <name> --seeds <n> ...

prints one JSON line a reading: {"seed", "side", "values"}, the
leaves that the change's comparison leaves out on each seed, and with
``--raw`` what the numbers were read from (each side's step losses and
leaf norms).  No window
is timed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=["half_batch", "token"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--raw", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from saturn_bench import cells, check, drive, faults

    cell = cells.load_cell(args.workload, ROOT)
    dev = torch.device(args.device)

    def program(seed, fault=None):
        with faults.planted(fault):
            built, params, state, _, ring, opt, prog = drive.start(
                cell, seed, dev, fault)
        del built, params, state
        drive.free(dev)
        return prog, ring, opt

    def emit(seed, side, values):
        print(json.dumps({"seed": seed, "side": side, "values": values}),
              flush=True)

    for n, seed in enumerate(args.seeds):
        prog, ring, opt = program(seed)
        ref = drive.reference(cell, opt, ring, seed, dev)
        drive.free(dev)
        emit(seed, "program", check.numbers(prog, ref))
        if args.raw:
            emit(seed, "raw_program", prog)
            emit(seed, "raw_reference", ref)
        emit(seed, "left_out_of_change", check.left_out(ref))
        if n >= 3:
            continue
        ctrl = drive.reference(cell, opt, ring, seed, dev, tf32=True)
        drive.free(dev)
        emit(seed, "control_tf32", check.numbers(ctrl, ref))
        if args.raw:
            emit(seed, "raw_control_tf32", ctrl)
        for fault in args.faults:
            prog, _, _ = program(seed, fault)
            emit(seed, "fault_" + fault, check.numbers(prog, ref))
    return 0


if __name__ == "__main__":
    sys.exit(main())
