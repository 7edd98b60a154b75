"""Child entry point for the ProcessTorchBackend: one training worker in
its own OS process.

The coordinator (:class:`~repro_torch.core.process_backend.ProcessTorchBackend`)
spawns this module's :func:`_worker_main` with a duplex pipe and a plain
``spec`` dict, and the two speak a small message protocol, the JAX
package's unchanged:

child -> parent
  ``{"msg": "hello", "start_step", "steps_to_run"}``
      sent once the checkpoint is loaded: the ABSOLUTE step the worker
      really resumed from (the durable checkpoint is the source of
      truth; the coordinator reconciles its own step accounting against
      this).
  ``{"msg": "hb", "steps", "t", "losses"}``
      heartbeat with the worker's step counter, from a dedicated thread
      that runs independently of the training thread — ``import torch``,
      the CUDA context and a multi-second checkpoint commit never look
      like a hang.
  ``{"msg": "ckpt", "step", "losses"}``
      checkpoint-ack: the checkpoint for ABSOLUTE ``step`` is durably
      committed on disk (atomic, checksummed).
  ``{"msg": "exit", "steps", "preempted", "losses", "compile_s",
  "measured_step_s"}``
      clean end of the segment (budget done or stop honored), after the
      final checkpoint commit.
  ``{"msg": "error", "reason"}``
      the training loop raised; the process exits 3 without
      checkpointing (recovery salvages the last durable commit).

parent -> child
  ``{"cmd": "stop"}``  checkpoint-and-exit (preemption);
  ``{"cmd": "hang"}``  fault injection: wedge — stop heartbeating AND
  stop making progress, but stay alive (the coordinator must detect the
  missed heartbeat deadline and kill the process).

A job of ``spec["world_size"]`` devices runs as that many children,
one a device: each is given its ``rank``, the ``world_size`` and the
``store`` address of the job's process group, joins the group
(``parallelism.dist.init_group``: NCCL on a card, gloo on the CPU), and
then builds the ``BuiltJob`` and the ``SyntheticLM`` stream; every rank
takes the same global batches, which the technique cuts.  A job of one
device is a group of one rank.  Rank 0 speaks the hello / ckpt / exit
protocol and owns the loss records; every rank heartbeats with its step
counter, and ``hang`` wedges the rank it is sent to.  A ``stop`` goes to
rank 0, which decides for the group: each step begins with a one-flag
all-reduce, so every rank ends at the same step (a rank that stopped
alone would leave the others waiting in the next collective).  Rank 0
writes the checkpoints: the full tree, gathered from every rank.

``spec["device"]`` is the rank's device (``"cpu"`` or ``"cuda:i"``,
indexed in the parent's own visible-device frame, which the child
inherits).  On the CPU the child runs ``spec["cpu_threads"]`` intra-op
threads, the coordinator's count at launch.  There is no compile cache
to enable: the port compiles nothing at run time (its steps are eager).

This module is deliberately import-lean: it pulls the model/optimizer/
data/checkpoint stacks but NEVER ``repro_torch.core`` (the scheduler),
and it imports torch only after the heartbeat thread is running.
"""
from __future__ import annotations

import os
import threading
import time


def _worker_main(conn, spec: dict) -> None:
    """Process target.  Any exception is reported over the pipe as an
    ``error`` message and the process exits 3 — the coordinator treats
    both the message and the bare death as the same failure."""
    try:
        _run(conn, spec)
    except BaseException as e:  # noqa: BLE001 — report, then die
        try:
            conn.send({"msg": "error",
                       "reason": f"{type(e).__name__}: {e}"})
        except Exception:
            pass
        os._exit(3)


def _run(conn, spec: dict) -> None:
    send_lock = threading.Lock()

    def send(m: dict) -> None:
        with send_lock:
            try:
                conn.send(m)
            except (BrokenPipeError, OSError):
                pass    # coordinator gone; nothing useful left to do

    state = {"steps": 0, "sent_losses": 0}
    losses: list = []           # (absolute step, loss), append-only
    loss_lock = threading.Lock()
    stop = threading.Event()
    hang = threading.Event()

    def send_with_losses(base: dict) -> None:
        # cursor + send under one lock so chunks from the sidecar and
        # the training thread (checkpoint acks) never reorder
        with loss_lock:
            chunk = losses[state["sent_losses"]:]
            state["sent_losses"] += len(chunk)
            base["losses"] = chunk
            send(base)

    def sidecar() -> None:
        # heartbeats + command listening, independent of the training
        # thread.  A wedged ("hang") worker goes silent for real — no
        # heartbeats, no command responses.  Heartbeats stream the loss
        # records accrued since the last one, so even a SIGKILLed
        # segment leaves its trajectory behind (append-only list +
        # cursor: safe against the training thread under the GIL).
        while not stop.is_set():
            try:
                if conn.poll(spec["heartbeat_every_s"]):
                    cmd = conn.recv()
                    if not hang.is_set():
                        if cmd.get("cmd") == "stop":
                            stop.set()
                        elif cmd.get("cmd") == "hang":
                            hang.set()
            except (EOFError, OSError):
                return
            if not hang.is_set() and not stop.is_set():
                send_with_losses({"msg": "hb", "steps": state["steps"],
                                  "t": time.monotonic()})

    # start heartbeating BEFORE the heavy setup (torch import, CUDA
    # context, init) so the coordinator's startup grace only has to
    # cover process spawn
    threading.Thread(target=sidecar, daemon=True,
                     name="saturn-hb").start()

    import torch
    import torch.distributed as dist

    from ..checkpoint.store import save_checkpoint
    from ..data.synthetic import SyntheticLM
    from ..device import resolve_device
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from ..parallelism.dist import init_group

    dev = resolve_device(spec["device"])
    if dev.type == "cpu":
        torch.set_num_threads(int(spec["cpu_threads"]))
    rank = spec["rank"]
    group = init_group(rank, spec["world_size"], spec["store"], dev)
    cfg = spec["model_cfg"]
    plan = spec["technique"].plan(cfg, spec["world_size"])
    total = spec["total_steps"]
    # Job.opt_cfg, rebuilt here so the child skips repro_torch.core
    opt_cfg = AdamWConfig(lr=spec["lr"],
                          warmup_steps=min(100, total // 10 + 1),
                          total_steps=total)
    built = BuiltJob(cfg, plan, opt_cfg, group=group)
    params, opt = built.init(spec["seed"])
    params, opt, start_step = built.load(spec["ckpt_path"], params, opt)
    # the durable checkpoint is authoritative: never run past the job's
    # total budget even when the coordinator's view lagged behind it
    steps_to_run = max(0, min(spec["steps_to_run"], total - start_step))
    if rank == 0:
        send({"msg": "hello", "start_step": start_step,
              "steps_to_run": steps_to_run})

    def commit(step_abs, loss):
        tree = built.full_state(params, opt)    # every rank takes part
        if tree is not None:                    # rank 0
            save_checkpoint(spec["ckpt_path"], tree,
                            {"step": step_abs, "loss": loss})
            # the ack flushes pending loss records: every step at or
            # below a durable checkpoint is then recorded parent-side,
            # so a later crash loses no trajectory (steps PAST the
            # checkpoint are replayed from it on resume)
            send_with_losses({"msg": "ckpt", "step": step_abs})

    data = SyntheticLM(cfg, seed=spec["seed"]).batches(
        spec["batch_size"], spec["seq_len"],
        num_batches=steps_to_run, skip=start_step, device=built.device)
    ckpt_every = int(spec.get("ckpt_every_steps", 0))
    flag = torch.zeros(1, device=built.device)
    loss = float("nan")
    compile_s = 0.0
    dt_sum, dt_n = 0.0, 0
    preempted = False
    for b in data:
        # rank 0 decides for the group whether this step runs
        flag.fill_(float(rank == 0 and stop.is_set()))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item():
            preempted = True
            break
        while hang.is_set():        # wedged for real: silent AND stuck
            time.sleep(0.05)
        t0 = time.perf_counter()
        params, opt, m = built.step(params, opt, built.place_batch(b))
        # the loss's copy to the host waits for the whole step
        loss = float(m.get("loss", float("nan")))
        dt = time.perf_counter() - t0
        if state["steps"] == 0:
            compile_s = dt
        else:
            dt_sum += dt
            dt_n += 1
        state["steps"] += 1
        if rank == 0:
            losses.append((start_step + state["steps"], loss))
        if ckpt_every and state["steps"] % ckpt_every == 0 \
                and state["steps"] < steps_to_run:
            commit(start_step + state["steps"], loss)
    commit(start_step + state["steps"], loss)
    stop.set()
    group.destroy()
    send({"msg": "exit", "steps": state["steps"], "preempted": preempted,
          "losses": losses, "compile_s": compile_s,
          "measured_step_s": (dt_sum / dt_n) if dt_n else None})
    conn.close()
