"""Training launcher: train an assigned architecture with a chosen
parallelism plan, on one device or as one process a device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --technique ddp --devices 1 --steps 100 --batch 8 --seq 512 \\
      [--reduced] [--ckpt build/ck.npz] [--resume] [--device cpu]

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch h2o-danube-3-4b --technique fsdp

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) each
process joins the job's process group (``parallelism.dist``: NCCL on
card ``LOCAL_RANK``, gloo with ``--device cpu``) and runs the plan at
``WORLD_SIZE`` devices as one rank: the counterpart of the JAX
launcher's one process a host.  Every rank reads the same batches;
rank 0 prints and writes the checkpoint, the full tree.  Without that
environment it runs one device, as ``--devices`` says.

The flags are the JAX package's launcher's, plus ``--device`` (default
``cuda``; there is no fallback to the CPU).  As there, ``--use-kernels``
is parsed and not read (training runs the plain paths), and ``--resume``
restores the parameters, optimizer state and step but starts the data
stream from its first batch.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--technique", default="fsdp")
    ap.add_argument("--devices", type=int, default=0,
                    help="0 = all local devices")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU smoke scale)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--use-kernels", action="store_true",
                    help="parsed for the JAX launcher's command line; "
                         "training runs the plain paths")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import os

    import torch

    from ..checkpoint.store import (load_checkpoint, load_metadata,
                                    save_checkpoint)
    from ..configs import get_config
    from ..core.library import ParallelismLibrary
    from ..data.synthetic import SyntheticLM
    from ..device import resolve_device
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from ..parallelism.dist import init_group

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    group = None
    if "RANK" in os.environ:            # one process of a torchrun launch
        n_dev = int(os.environ["WORLD_SIZE"])
        if args.devices and args.devices != n_dev:
            raise SystemExit(f"--devices {args.devices} under a launch of "
                             f"{n_dev} processes")
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        group = init_group(int(os.environ["RANK"]), n_dev, "env://", dev)
    else:
        n_dev = args.devices or (torch.cuda.device_count()
                                 if dev.type == "cuda" else 1)
    lib = ParallelismLibrary()
    tech = lib.get(args.technique)
    if not tech.search_space(cfg, n_dev):
        raise SystemExit(
            f"{args.technique} invalid for {cfg.name} at {n_dev} devices "
            f"(valid: {[t for t, g in lib.candidates(cfg, [n_dev])]})")
    plan = tech.plan(cfg, n_dev)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    built = BuiltJob(cfg, plan, opt_cfg, device=dev, group=group)
    say = print if built.is_writer else (lambda *a, **k: None)
    params, opt = built.init(0)
    start = 0
    if args.resume and args.ckpt:
        meta = load_metadata(args.ckpt) or {}
        start = int(meta.get("step", 0))
        state = load_checkpoint(args.ckpt, {"params": params, "opt": opt},
                                cut=built.cut_array)
        params, opt = state["params"], state["opt"]
        say(f"resumed from {args.ckpt} at step {start}")

    say(f"{cfg.name}: {args.technique} x{n_dev} devices, "
        f"batch {args.batch} x seq {args.seq}, steps {start}..{args.steps}")
    data = SyntheticLM(cfg, seed=0).batches(
        args.batch, args.seq, num_batches=args.steps - start, device=dev)
    t0 = time.perf_counter()
    m = {}
    for i, b in enumerate(data, start=start):
        params, opt, m = built.step(params, opt, built.place_batch(b))
        if (i + 1) % args.log_every == 0:
            loss = float(m["loss"])               # waits for the step
            dt = (time.perf_counter() - t0) / (i + 1 - start)
            say(f"step {i + 1:6d}  loss {loss:.4f}  "
                f"ppl {float(m['perplexity']):.1f}  "
                f"grad_norm {float(m['grad_norm']):.2f}  "
                f"{dt * 1e3:.0f} ms/step", flush=True)
    if args.ckpt:
        tree = built.full_state(params, opt)     # every rank takes part
        if tree is not None:                     # rank 0
            save_checkpoint(args.ckpt, tree,
                            {"step": args.steps,
                             "loss": float(m.get("loss", float("nan")))})
        say(f"saved {args.ckpt}")
    if group is not None:
        group.destroy()


if __name__ == "__main__":
    main()
