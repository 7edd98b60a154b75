#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and holds each against its plain PyTorch version.  Then, with random
weights from a seed, in bf16:

- gemma3-4b at full width: a batched prefill with the flash-attention
  kernel in all 34 layers, greedy decode from the prefill's caches, and
  the continuous-batching engine answering 8 requests;
- xlstm-125m at full width: the forward with the mLSTM-chunk and
  sLSTM-step kernels in all 12 layers, then serving as the reference
  does it (prefill on the plain recurrences, greedy decode from its
  state, the engine answering 8 requests);
- recurrentgemma-2b at full width: a batched prefill with the RG-LRU
  scan kernel in its 18 recurrent layers and flash attention in its 8
  window-2048 layers, greedy decode from the prefill's state, and the
  engine answering 8 requests;
- olmoe-1b-7b at full width (16 layers, 64 experts, top-8): one MoE
  block on the card against the CPU (``moe_check``: equal routes, two
  bf16 runs bit-equal), a batched prefill with flash attention in all
  16 layers and the share of routed pairs dropped at capacity, greedy
  decode from the prefill's caches, the engine answering 8 requests and
  ``measure_serve_step_time`` at full width.

Flash attention is also held against its plain version at the head dims
the kernels pad (D 120, h2o-danube-3-4b; D 160, stablelm-12b) in both
dtypes, and timed with SDPA beside it at D 64, 128 and 256 at fixed FLOPs
and at the D 64 configs' heads (``flash_d_sweep``); the sLSTM kernel is
held at the xLSTM shape in fp32 as well.  Before
any of that, each of the four wrappers is shown to refuse a CUDA input
that requires grad while grad mode is on, and to launch under
``torch.no_grad()``.

Then training, in fp32 on the model's plain paths (the kernels have no
backward, and the JAX package trains without them), with the four
kernels' launch counters held at 0 throughout:

- ``train_check`` and ``moe_train_check``: one train step of
  xlstm-125m.reduced() and of olmoe-1b-7b.reduced() (its loss with the
  MoE aux) through ``BuiltJob`` on the card and on the CPU from the same
  parameters and batch, held together;
- ``train_step``: xlstm-125m at full width cut to ``HOST_LAYERS`` (4)
  layers, B 8 x S 512, through ``BuiltJob`` at ``ddp`` and at
  ``remat-offload``, one warm-up and one timed step at ``ddp`` (and the
  forward alone), the warm-up step alone
  at ``remat-offload``, then a warm-up and a timed step with the
  batched-gradient sLSTM scan;
- ``train_resume``: in a child process with deterministic algorithms on,
  four straight steps against two steps, a checkpoint, a resume and two
  more steps, bit-equal;
- ``train_cli``: ``python -m repro_torch.launch.train`` on the whole
  xlstm-125m (S 128) for one step, leaving a checkpoint that verifies.

Then process groups (``parallelism.dist``; the one card holds one rank
of NCCL, which refuses two ranks on one device, so the multi-rank checks
are ``tests/test_torch_parallelism.py`` on the CPU and
``python -m repro_torch.testing.parallel_check ARCH --ranks 4`` on four
cards, its default device; ``--device cpu`` runs its ranks on gloo):

- ``par_group1``: xlstm-125m at full width and 4 layers, B 8 x S 128,
  ``ddp`` and ``remat-offload`` two steps each through ``BuiltJob`` as
  rank 0 of a world-size-1 NCCL group, held bit for bit (losses, grad
  norms, every parameter) against the no-group ``BuiltJob``, with the
  group's set-up, NCCL's version, s a step and peak memory;
- ``par_2d_group1``: the same for the dry run's rules plan on (data 1,
  model 1) (two mesh axes, their flattened group, the bucketed gradient
  all-reduce), against the no-group ``ddp`` step; then, in that group,
  a prefill of B 8 x S 128 and four greedy decode steps from it under
  the rules plan with the decode state placed by ``cache_shardings``,
  tokens, logits and every state leaf bit-equal to the no-group
  ``prefill_forward`` and ``decode_step``; and four greedy steps of
  h2o-danube-3-4b reduced with each row at its own position (a (B,)
  ``pos``, as continuous batching decodes) from a random state, the
  same gate;
- ``dryrun_one``: one full-width combination of the multi-pod dry run,
  gemma3-4b ``train_4k`` on the 16x16 mesh, through ``run_one`` on the
  host's CPU (rank 0's step traced on meta tensors in a fake group of
  256 ranks), gated on ``status == "ok"``, with its ``wall_s``;
- ``dryrun_decode``: the same for three decode combinations on the
  16x16 mesh, each record's flops, collective payload by kind, argument
  and peak bytes: stablelm-12b ``decode_32k`` under ``--preset
  optimized`` (its KV cache cut by sequence over model, its q heads by
  the rules; the batch cut), and two where the batch is whole, so the
  weights stay where they lie and only activations move:
  h2o-danube-3-4b ``long_500k`` (B 1) and olmoe-1b-7b ``decode_32k``
  under ``optimized`` (the MoE preset leaves the batch whole).

Then Saturn's own loop (profile -> solve -> execute -> observe ->
replan) on xlstm-125m jobs at full width and 4 layers (the steps are
host-bound, so depth sets the phases' time), B 8 x S 128, fp32, with the
kernel counters still held at 0 (checkpoints under ``build/saturn/``,
removed after each phase):

- ``saturn_profile``: the empirical Trial Runner, one warm-up and two
  timed steps at ``ddp`` x1 and ``remat-offload`` x1, against the
  card's own ``HardwareSpec``;
- ``saturn_roofline_loops``: the step analyzer on the whole
  xlstm-125m's ``ddp`` x1 train step at B 16, S 1024 and 2048: each
  analysis's wall seconds and dispatched ops, gated equal at the two
  lengths (each time loop counted once and charged for its trips);
- ``saturn_roofline``: the roofline strategy on that runner, its two
  trials the calibration, every other count up to 8 of the probe and of
  a held-out job at B 16 predicted from one step analysis each (each
  gated to come from its own step's analysis); the held-out job's real
  x1 trials against their predictions and the analyzer's peak bytes;
  the whole gemma3-4b's training step analysed at every (technique,
  count <= 8) against the card's memory;
- ``saturn_fidelity``: two jobs under one SaturnStatic schedule,
  predicted by the SimBackend and executed by ``LocalTorchBackend``;
- ``saturn_restart``: an introspection replan flips j0 from ``ddp`` x1
  to ``remat-offload`` x1 mid-run (checkpoint, restart, resume), and j0
  is rerun straight through ``BuiltJob`` to hold its losses;
- ``saturn_session``: ``SaturnSession`` profiles two jobs with
  ``profile()``'s defaults (the analytic mode, gated to come from the
  steps' analyses), then empirically and exhaustively (real trials),
  and trains them through ``run(backend="local")`` on the latter;
- ``saturn_portfolio_fork``: the solver portfolio's MILP-vs-LNS races,
  each forking a child for the MILP leg, while a worker trains.

Then the process backend, each job segment in its own supervised child
process (``ProcessTorchBackend``, started with ``spawn``), each child
rank 0 of a world-size-1 NCCL group:

- ``proc_session``: ``SaturnSession(...).run(backend="process")`` of two
  full-width jobs from napkin profiles, each job's losses held to a
  straight ``BuiltJob`` run bit for bit, with each launch's seconds from
  spawn to hello, warm-up, step, commit and largest heartbeat gap;
- ``proc_recover``: the JAX package's ``bench_recover`` scenarios on
  xlstm-micro (baseline, sigkill, hang, corrupt, a zero retry budget)
  and one full-width sigkill, each recovered trajectory equal to the
  uninterrupted one;
- ``proc_portfolio``: the races of ``saturn_portfolio_fork`` while the
  full-width worker trains in a child process instead of a thread.

Every phase prints one JSON line and raises on failure.  The line
before the last lists every ported kernel; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA
device or without the repo's ``src/repro_torch`` beside this script.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
PREFILL_B, PREFILL_S = 4, 4096
GEN_TOKENS = 32
XLSTM_B, XLSTM_S = 8, 4096          # the xLSTM forward and kernel cases
XLSTM_SERVE_B, XLSTM_SERVE_S = 4, 1024
MLSTM_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # tests/test_kernels.py
# sLSTM: fp32 as tests/test_kernels.py; bf16 outputs are the same fp32
# state rounded once, so one bf16 step of |h| <= 1
SLSTM_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -8, 0.0)}
RGLRU_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
RGLRU_RTOL = 1e-2
TRAIN_B, TRAIN_S = 8, 512    # the JAX launcher's defaults (launch/train.py)
# timed steps, after one warm-up step (each step is host-bound, 6-20 s);
# remat-offload runs its warm-up step alone
TRAIN_STEPS = {"ddp": 1, "remat-offload": 0}
CLI_STEPS = 1                # launch.train's steps in train_cli
CHECK_B, CHECK_S = 4, 64     # train_check and train_resume, reduced config
SATURN_B, SATURN_S = 8, 128  # the Saturn jobs' batch and sequence
# xlstm-125m's depth in the host-bound phases (train_step, par_group1, the
# Saturn and proc jobs): two blocks of each kind at full width (12 in
# full, which xlstm_forward and train_cli run)
HOST_LAYERS = 4
ROOFLINE_COUNTS = [1, 2, 4, 8]
# saturn_restart: the segmented run's losses against a straight run of the
# same steps on the same card, relative
SATURN_LOSS_RTOL = 1e-6
# the process backend's phases: full-width jobs of PROC_STEPS steps; the
# recover scenarios on xlstm-micro (bench_recover's config) at
# RECOVER_STEPS steps (the bench's quick run has 400), each fault deferred
# to the second durable commit, and the bench's overhead gate, reported
PROC_STEPS = 3
PROC_LRS = (1e-3, 3e-4)
RECOVER_STEPS = 100
RECOVER_FAULT_T, RECOVER_MIN_STEP = 1.0, 20
RECOVER_OVERHEAD_GATE = 4.0
# train_check, CUDA against CPU at fp32: loss and grad_norm relative; the
# parameters after one step at lr 1e-3 absolute (the CPU tests hold the
# port to the JAX package at 1e-4 on xlstm-micro)
TRAIN_CHECK_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4}
# moe_check: one olmoe-1b-7b MoE block, B 2 x S 256, fp32, CUDA against
# the CPU: gate weights (probabilities <= 1, a few ulps) absolute, the
# output relative to its largest value (fp32 products of depth 2048 and
# 1024, TF32 off)
MOE_CHECK_B, MOE_CHECK_S = 2, 256
MOE_W_ATOL, MOE_FP32_RTOL = 1e-6, 1e-5
# par_group1: full-width xlstm-125m at the Saturn jobs' shape, PAR_STEPS
# steps a technique, as rank 0 of a world-size-1 NCCL group and without a
# group; par_2d_group1 the same for the dry run's rules plan on this mesh
PAR_STEPS = 2
PAR_2D_MESH = (("data", 1), ("model", 1))
# par_2d_group1's decode: greedy steps from a prefill of SATURN_B x
# SATURN_S
PAR_DECODE_STEPS = 4
# dryrun_one / dryrun_decode: (arch, shape, multi_pod, preset) of the dry
# run's combinations
DRYRUN_ONE = ("gemma3-4b", "train_4k", False, "baseline")
# saturn_roofline_loops: the batch of its whole-xlstm-125m analyses
ROOFLINE_LOOPS_B = 16
DRYRUN_DECODE = (("stablelm-12b", "decode_32k", False, "optimized"),
                 ("h2o-danube-3-4b", "long_500k", False, "baseline"),
                 ("olmoe-1b-7b", "decode_32k", False, "optimized"))


def emit(phase, **kv):
    """One JSON line; ``elapsed_s`` counts from this module's import."""
    print(json.dumps({"phase": phase, **kv,
                      "elapsed_s": time.perf_counter() - T_IMPORT}),
          flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, runs=10, warmup=2):
    """Median over ``runs`` of one call's device time (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def live_pairs(s, window):
    """(query, key) pairs inside the causal band and the window."""
    if not window:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_bound(b, s, h, kv, d, window, dtype_name, itemsize):
    flops = 4.0 * d * live_pairs(s, window) * b * h
    nbytes = float(itemsize) * (2 * b * s * h * d + 2 * b * s * kv * d)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def roofline(flops, nbytes, peak):
    """(bound_ms, bound_by) for ``flops`` at ``peak`` FLOP/s and
    ``nbytes`` at the memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlstm_bound(b, s, h, d, dtype_name, itemsize):
    """Chunkwise form: B*H*S*(4*L*D + 4*D^2) FLOPs, all of them matrix
    products; q, k, v, out and the two gates each moved once; L is the
    kernel's chunk length.  The products are counted on the tensor cores:
    bf16 for bf16 inputs, TF32 for fp32 ones (the fp32 tolerance,
    2e-3 + 5e-2*|ref|, admits TF32 products)."""
    from repro_torch.kernels.mlstm_chunk import CHUNK
    flops = float(b) * h * s * (4 * CHUNK * d + 4 * d * d)
    nbytes = float(itemsize) * (4 * b * s * h * d + 2 * b * s * h)
    peak = PEAK_FLOPS["bfloat16"] if dtype_name == "bfloat16" else PEAK_TF32
    return roofline(flops, nbytes, peak)


def slstm_bound(b, s, h, d, dtype_name, itemsize):
    """Four recurrent matvecs a step, B*H*S*8*D^2 FLOPs; gates, out and
    the four R each moved once.  The products are counted at the bf16
    tensor peak for bf16 inputs and at the fp32 peak for fp32 ones (the
    fp32 tolerance, 1e-5, does not admit TF32).  The chain of S dependent
    steps is what this bound does not see."""
    flops = 8.0 * b * h * s * d * d
    nbytes = float(itemsize) * (5 * b * s * h * d + 4 * h * d * d)
    return roofline(flops, nbytes, PEAK_FLOPS[dtype_name])


def sdpa(q, k, v, window):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = q.shape[1]
    if window:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = (j <= i) & ((i - j) < window)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             scale=1.0, enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             scale=1.0, enable_gqa=True)
    return out.transpose(1, 2)


def check_close(name, shape, dtype, out, ref, atol, rtol):
    diff = (out.float() - ref).abs()
    max_err = float(diff.max())
    if not bool((diff <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"{name} {shape} {dtype}: max_err {max_err} "
                             f"beyond atol {atol}, rtol {rtol}")
    return max_err


def kernel_case(fa, plain, gen, b, s, h, kv, d, window, dtype, tol):
    import torch
    q = (torch.randn(b, s, h, d, generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
    n0 = fa.launches
    out = fa(q, k, v, window)
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    max_err = check_close("flash_attention", (b, s, h, kv, d, window), name,
                          out, plain(q, k, v, window).float(), tol, tol)
    bound_ms, bound_by = attention_bound(b, s, h, kv, d, window, name,
                                         q.element_size())
    return {"shape": [b, s, h, kv, d], "window": window, "dtype": name,
            "tol": tol, "max_err": max_err,
            "kernel_ms": time_ms(lambda: fa(q, k, v, window)),
            "launches": fa.launches - n0,
            "plain_ms": time_ms(lambda: plain(q, k, v, window)),
            "library_ms": time_ms(lambda: sdpa(q, k, v, window)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def flash_d_sweep(gen):
    """Flash attention at B 4 x S 4096, window 0, bf16, with SDPA beside
    it: at D 64, 128 and 256 with H * D = 2048 and Kv = H (the same
    FLOPs), then at the heads of the D 64 configs, internvl2-1b and
    musicgen-medium, which run no model on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cases = []
    for d in (64, 128, 256):
        h = 2048 // d
        cases.append({"fixed_flops": True, **kernel_case(
            flash_attention, flash_attention_plain, gen, PREFILL_B,
            PREFILL_S, h, h, d, 0, torch.bfloat16, 2e-2)})
    for arch in ("internvl2-1b", "musicgen-medium"):
        c = get_config(arch)
        cases.append({"config": arch, **kernel_case(
            flash_attention, flash_attention_plain, gen, PREFILL_B,
            PREFILL_S, c.num_heads, c.num_kv_heads, c.resolved_head_dim, 0,
            torch.bfloat16, 2e-2)})
    return cases


def mlstm_case(kern, plain, gen, b, s, h, d, dtype, strided=False):
    """The mLSTM kernel against its plain version on the inputs of
    tests/test_kernels.py (standard normal; forget pre-activations
    around +2).  ``strided``: q, k and v are the first D columns of
    (B, S, H, D + 32) tensors, and i and f the two halves of one
    (B, S, H, 2) tensor, so that every input is read by strides."""
    import torch
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    if strided:
        q, k, v = (rnd(b, s, h, d + 32).to(dtype)[..., :d] for _ in range(3))
        gates = rnd(b, s, h, 2)
        gates[..., 1] = gates[..., 1] * 2 + 2
        ip, fp = gates.to(dtype).unbind(-1)
    else:
        q, k, v = (rnd(b, s, h, d).to(dtype) for _ in range(3))
        ip = rnd(b, s, h).to(dtype)
        fp = (rnd(b, s, h) * 2 + 2).to(dtype)
    xs = (q, k, v, ip, fp)
    name = str(dtype).replace("torch.", "")
    n0 = kern.launches
    out = kern(*xs)
    torch.cuda.synchronize()
    tol = MLSTM_TOL[name]
    max_err = check_close("mlstm_chunk", (b, s, h, d), name, out,
                     plain(*xs).float(), tol, 5e-2)
    bound_ms, bound_by = mlstm_bound(b, s, h, d, name, q.element_size())
    return {"kernel": "mlstm_chunk", "shape": [b, s, h, d], "dtype": name,
            "strided": strided, "tol": [tol, 5e-2], "max_err": max_err,
            "kernel_ms": time_ms(lambda: kern(*xs)),
            "launches": kern.launches - n0,
            "plain_ms": time_ms(lambda: plain(*xs), runs=3, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def slstm_case(kern, plain, gen, b, s, h, d, dtype):
    """The sLSTM kernel against its plain version on the inputs of
    tests/test_kernels.py (gates N(0, 0.5^2), R N(0, 0.05^2)).  The plain
    version is a loop over S steps, so it is timed once after the check."""
    import torch
    from repro_torch.kernels.slstm_step import cluster_split, mma_cluster
    gates = (torch.randn(b, s, h, d, 4, generator=gen, device="cuda")
             * 0.5).to(dtype)
    rs = [(torch.randn(h, d, d, generator=gen, device="cuda") * 0.05)
          .to(dtype) for _ in range(4)]
    name = str(dtype).replace("torch.", "")
    n0 = kern.launches
    out = kern(gates, *rs)
    torch.cuda.synchronize()
    atol, rtol = SLSTM_TOL[name]
    max_err = check_close("slstm_step_scan", (b, s, h, d), name, out,
                     plain(gates, *rs).float(), atol, rtol)
    bound_ms, bound_by = slstm_bound(b, s, h, d, name,
                                     gates.element_size())
    cluster = (mma_cluster(d) if dtype == torch.bfloat16
               else cluster_split(d).cluster)
    return {"kernel": "slstm_step_scan", "shape": [b, s, h, d],
            "dtype": name, "cluster": cluster, "tol": [atol, rtol],
            "max_err": max_err,
            "kernel_ms": time_ms(lambda: kern(gates, *rs)),
            "launches": kern.launches - n0,
            "plain_ms": time_ms(lambda: plain(gates, *rs), runs=1, warmup=0),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def rglru_bound(b, s, r, dtype_name, itemsize):
    """a and b read once and h written once; one multiply-add (two
    operations) a step and channel."""
    return roofline(2.0 * b * s * r, 3.0 * itemsize * b * s * r,
                    PEAK_FLOPS[dtype_name])


def rglru_case(kern, plain, gen, b, s, r, dtype, offset=0):
    """The RG-LRU kernel against its plain version on the inputs of
    tests/test_kernels.py (a in (0.8, 1), b ~ N(0, 0.1^2)).  ``offset``:
    a and b start that many elements into their buffers (contiguous, but
    not aligned to a pair of channels or to 16 bytes)."""
    import torch
    rnd = lambda: torch.randn(b, s, r, generator=gen, device="cuda")

    def place(x):
        buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
        out = buf[offset:].view(b, s, r)
        out.copy_(x)
        return out
    a = place((torch.sigmoid(rnd()) * 0.2 + 0.8).to(dtype))
    x = place((rnd() * 0.1).to(dtype))
    name = str(dtype).replace("torch.", "")
    n0 = kern.launches
    out = kern(a, x)
    torch.cuda.synchronize()
    tol = RGLRU_TOL[name]
    max_err = check_close("rglru_scan", (b, s, r), name, out,
                          plain(a, x).float(), tol, RGLRU_RTOL)
    bound_ms, bound_by = rglru_bound(b, s, r, name, a.element_size())
    return {"kernel": "rglru_scan", "shape": [b, s, r], "dtype": name,
            "offset": offset, "tol": [tol, RGLRU_RTOL], "max_err": max_err,
            "kernel_ms": time_ms(lambda: kern(a, x)),
            "launches": kern.launches - n0,
            "plain_ms": time_ms(lambda: plain(a, x)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def grad_rule():
    """Each kernel wrapper refuses a CUDA input that requires grad while
    grad mode is on (the kernels have no backward yet, ROADMAP B10), and
    launches on the same inputs under torch.no_grad()."""
    import torch
    from repro_torch.kernels.ops import (flash_attention, mlstm_chunk,
                                         rglru_scan, slstm_step_scan)
    rnd = lambda *shape: torch.randn(*shape, device="cuda",
                                     dtype=torch.bfloat16)
    calls = {
        "flash_attention": (flash_attention, lambda: [
            rnd(1, 64, 2, 64) * 0.125, rnd(1, 64, 2, 64), rnd(1, 64, 2, 64)]),
        "mlstm_chunk": (mlstm_chunk, lambda: [
            rnd(1, 64, 1, 64), rnd(1, 64, 1, 64), rnd(1, 64, 1, 64),
            rnd(1, 64, 1), rnd(1, 64, 1) + 2]),
        "rglru_scan": (rglru_scan, lambda: [
            torch.sigmoid(rnd(1, 64, 128)), rnd(1, 64, 128) * 0.1]),
        "slstm_step_scan": (slstm_step_scan, lambda: [
            rnd(1, 16, 1, 16, 4) * 0.5,
            *(rnd(1, 16, 16) * 0.05 for _ in range(4))]),
    }
    out = {}
    for name, (fn, make) in calls.items():
        xs = make()
        xs[0].requires_grad_(True)
        n0 = fn.launches
        refused = ""
        with torch.enable_grad():
            try:
                fn(*xs)
            except RuntimeError as err:
                refused = str(err)
        if "B10" not in refused or fn.launches != n0:
            raise AssertionError(f"{name} did not refuse a grad-requiring "
                                 f"CUDA input under grad mode: {refused!r}")
        with torch.no_grad():
            y = fn(*xs)
        torch.cuda.synchronize()
        if fn.launches != n0 + 1 or y.requires_grad or \
                not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"{name} did not launch under no_grad")
        out[name] = {"refused_under_grad": True,
                     "launched_under_no_grad": True}
    return out


def small_check(cfg):
    """At fp32 on a reduced config, B 2, S 8 (a size where random-init
    models are not chaotic): the kernel path against the plain path end
    to end, and teacher-forced decode against the forward's last
    logits."""
    import torch
    from repro_torch.configs import concrete_batch
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state, init_model)
    sp = init_model(cfg, seed=1, dtype=torch.float32, device="cuda")
    sb = concrete_batch(cfg, 2, 8, device="cuda")
    lk, _ = forward(sp, cfg, sb)
    lp, _ = forward(sp, cfg, sb, opts={})
    st = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cuda")
    for i in range(8):
        ld, st = decode_step(sp, cfg, sb["tokens"][:, i:i + 1], st)
    err = {"kernel_vs_plain": float((lk - lp).abs().max()),
           "decode_vs_forward": float((ld[:, 0] - lk[:, -1]).abs().max())}
    if err["kernel_vs_plain"] > 1e-4 or err["decode_vs_forward"] > 5e-4:
        raise AssertionError(f"{cfg.name} small check failed: {err}")
    return err


def comparing(errs, kern, plain, atol=None, rtol=None):
    """``kern``, appending to ``errs`` on every call (the model's own
    activations) its error against ``plain``: relative to the plain
    output's largest value, or, given ``atol`` and ``rtol``, the worst
    |out - ref| / (atol + rtol * |ref|) over the elements, which is at
    most 1 inside that bound."""
    def fn(*args):
        out = kern(*args)
        ref = plain(*args).float()
        diff = (out.float() - ref).abs()
        if atol is None:
            errs.append(float(diff.max() / ref.abs().max()))
        else:
            errs.append(float((diff / (atol + rtol * ref.abs())).max()))
        return out
    return fn


def comparing_attention(errs, kern, plain, tol):
    """``kern`` (flash attention), appending to ``errs`` on every call
    its worst elementwise |out - ref| / (tol * (P|V| + |ref|)) against
    ``plain``, at most 1 inside the bound.  P|V|, the plain attention of
    |v|, is the scale of each output's error: the kernel rounds the
    probabilities P to bf16 before P V, an error of at most
    2^-9 * sum_j p_j |v_j| in each output, where |ref| = |sum_j p_j v_j|
    can be far smaller (the model's v are not unit-scale as the kernel
    cases' are)."""
    def fn(q, k, v, window):
        out = kern(q, k, v, window)
        ref = plain(q, k, v, window).float()
        scale = plain(q, k, v.abs(), window).float()
        diff = (out.float() - ref).abs()
        errs.append(float((diff / (tol * (scale + ref.abs()) + 1e-30)).max()))
        return out
    return fn


def seeded_state(cfg, pstate, batch, seq, length):
    """A decode state of ``length`` holding the prefill's ``pstate``:
    KV caches along their sequence axis, recurrent leaves whole."""
    import torch
    from repro_torch.models.transformer import (init_decode_state,
                                                state_batch_axes)
    state = init_decode_state(cfg, batch, length, dtype=torch.bfloat16,
                              device="cuda")
    axes = state_batch_axes(cfg)["layers"]
    for gi, group in enumerate(pstate["layers"]):
        for key, cache in group.items():
            for leaf, src_t in cache.items():
                dst = state["layers"][gi][key][leaf]
                if dst.shape != src_t.shape:
                    dst = dst.narrow(axes[gi][key][leaf] + 1, 0, seq)
                dst.copy_(src_t)
    state["pos"] = torch.tensor(seq, dtype=torch.int32, device="cuda")
    return state


def greedy(cfg, params, logits, state, steps):
    """``steps`` greedy decode steps from the last logits and ``state``.
    Returns (tokens (B, steps + 1), seconds)."""
    import torch
    from repro_torch.train.steps import make_serve_step
    serve_step = make_serve_step(cfg)
    pos0 = int(state["pos"])
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    generated = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, step_logits, state = serve_step(params, tok, state)
        generated.append(tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    toks = torch.cat(generated, dim=1)
    if int(state["pos"]) != pos0 + steps or \
            not bool(torch.isfinite(step_logits).all()) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name} greedy decode produced bad state "
                             "or tokens")
    return toks, seconds


def serve_requests(cfg, params, seed):
    """The engine answering 8 requests (prompts of 16-128 tokens, 16-32
    new tokens each) on 4 slots.  Returns (seconds, its throughput)."""
    import torch
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    rng = torch.Generator().manual_seed(seed)
    eng = ContinuousBatchingEngine(cfg, params, slots=4, max_len=160,
                                   dtype=torch.bfloat16, device="cuda")
    for rid in range(8):
        plen = int(torch.randint(16, 129, (1,), generator=rng))
        prompt = torch.randint(0, cfg.vocab_size, (plen,),
                               generator=rng).tolist()
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=int(torch.randint(
                               16, 33, (1,), generator=rng)),
                           arrival_s=0.0))
    t0 = time.perf_counter()
    done = eng.run()
    seconds = time.perf_counter() - t0
    if len(done) != 8 or any(len(r.output) != r.max_new_tokens
                             for r in done):
        raise AssertionError(f"{cfg.name}: the engine did not finish all 8 "
                             "requests")
    return seconds, eng.throughput()


def xlstm_phases(gen):
    """The xLSTM slice: its kernels against their plain versions, a
    small end-to-end check, the full-width forward through both kernels,
    and serving.  Returns the two kernels' entries of the kernels line."""
    import torch
    from repro_torch.configs import concrete_batch, get_config
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain
    from repro_torch.kernels.slstm_step import (slstm_step_plain,
                                                slstm_step_scan)
    from repro_torch.models.params import param_count, tree_map
    from repro_torch.models.transformer import (forward, init_model,
                                                model_spec, prefill_forward)

    cfg = get_config("xlstm-125m")
    nh, d = cfg.num_heads, cfg.d_model
    dm, ds = 2 * d // nh, d // nh          # mLSTM and sLSTM head dims

    # -------------------------------------------------- xLSTM kernels
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        # the shapes of tests/test_kernels.py, then ragged S (the mLSTM
        # kernel masks its last chunk) at the model's head dim, D 96 (a
        # 96-column value tile, 3 head-dim slabs), the smallest and largest
        # D the kernels take and one of 32-column value tiles, and every
        # input read by strides
        for s, h, hd in [(256, 2, 64), (512, 4, 128), (200, nh, dm),
                         (37, 2, 96), (100, 2, 32), (130, 1, 160),
                         (70, 1, 512)]:
            cases.append(mlstm_case(mlstm_chunk, mlstm_chunk_plain, gen,
                                    2, s, h, hd, dtype))
        cases.append(mlstm_case(mlstm_chunk, mlstm_chunk_plain, gen, 2, 200,
                                nh, dm, dtype, strided=True))
        for s, h, hd in [(256, 2, 128), (128, 4, 64), (256, 1, 256),
                         (300, nh, ds)]:
            cases.append(slstm_case(slstm_step_scan, slstm_step_plain, gen,
                                    2, s, h, hd, dtype))
    main_m = mlstm_case(mlstm_chunk, mlstm_chunk_plain, gen, XLSTM_B,
                        XLSTM_S, nh, dm, torch.bfloat16)
    main_s = slstm_case(slstm_step_scan, slstm_step_plain, gen, XLSTM_B,
                        XLSTM_S, nh, ds, torch.bfloat16)
    # the fp32 kernel at the main shape too (not on the model's path):
    # B 8 x H 4 clusters, one a (batch row, head), and half as many
    main_s32 = slstm_case(slstm_step_scan, slstm_step_plain, gen, XLSTM_B,
                          XLSTM_S, nh, ds, torch.float32)
    half_s32 = slstm_case(slstm_step_scan, slstm_step_plain, gen,
                          XLSTM_B // 2, XLSTM_S, nh, ds, torch.float32)
    cases += [main_m, main_s, main_s32, half_s32]
    emit("xlstm_kernels", cases=cases)

    # ---------------------------------------------------- small check
    # 2 layers; the plain sLSTM is the step scan, at fp32 the kernel's math
    small = cfg.reduced()
    emit("xlstm_check", config=small.name, **small_check(small))

    # --------------------------------------------------- xLSTM forward
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model_spec(cfg))
    if not 0.10e9 <= n_params <= 0.17e9:
        raise AssertionError(f"xlstm param_count {n_params}")
    batch = concrete_batch(cfg, XLSTM_B, XLSTM_S, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    forward(params, cfg, batch)                  # warm-up (cuBLAS)
    torch.cuda.synchronize()
    mlstm_chunk.launches = slstm_step_scan.launches = 0
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, batch)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = {"mlstm_chunk": mlstm_chunk.launches,
                "slstm_step_scan": slstm_step_scan.launches}
    kinds = cfg.layer_types()
    expected = {"mlstm_chunk": kinds.count("mlstm"),
                "slstm_step_scan": kinds.count("slstm")}
    if launches != expected:
        raise AssertionError(f"xLSTM forward launches {launches}, "
                             f"expected {expected}")
    if logits.shape != (XLSTM_B, XLSTM_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("xLSTM logits not finite / wrong shape")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del logits

    # mLSTM outputs are heavy-tailed (the normaliser divides), so its
    # layers are held elementwise to the kernel cases' bf16 bound, as a
    # share of it; the sLSTM's |h| <= 1, so relative to the largest value
    layer_err = {"mlstm_chunk": [], "slstm_step_scan": []}
    mtol = MLSTM_TOL["bfloat16"]
    forward(params, cfg, batch, opts={
        "mlstm_fn": comparing(layer_err["mlstm_chunk"], mlstm_chunk,
                              mlstm_chunk_plain, atol=mtol, rtol=5e-2),
        "slstm_fn": comparing(layer_err["slstm_step_scan"], slstm_step_scan,
                              slstm_step_plain)})
    bounds = {"mlstm_chunk": 1.0, "slstm_step_scan": 1e-2}
    for name, errs in layer_err.items():
        if len(errs) != expected[name] or max(errs) > bounds[name]:
            raise AssertionError(f"{name} per-layer error {errs}, bound "
                                 f"{bounds[name]}")
    emit("xlstm_forward", config=cfg.name, param_count=n_params,
         batch=XLSTM_B, seq=XLSTM_S, init_s=init_s, forward_s=forward_s,
         tokens_per_s=XLSTM_B * XLSTM_S / forward_s, launches=launches,
         layer_err=layer_err, layer_err_bound=bounds,
         layer_err_means={"mlstm_chunk": f"max |out-ref|/({mtol} + 5e-2|ref|)",
                          "slstm_step_scan": "max |out-ref| / max |ref|"},
         peak_mem_gb=peak_gb)

    # --------------------------------------------------- xLSTM serving
    # as the reference serves: prefill on the plain recurrences (it
    # needs the final state), then decode from that state
    batch = concrete_batch(cfg, XLSTM_SERVE_B, XLSTM_SERVE_S, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill_forward(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if logits.shape != (XLSTM_SERVE_B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or \
            int(state["pos"]) != XLSTM_SERVE_S:
        raise AssertionError("xLSTM prefill logits / state wrong")
    # the forward (kernels; the sLSTM carries h in fp32) and the prefill
    # (the reference's scan carries h in bf16) are one function at fp32
    # and two under bf16: their last logits are recorded against each
    # other and against the fp32 forward of the same weights, relative
    # to its largest logit
    p32 = tree_map(lambda t: t.float(), params)
    ref = forward(p32, cfg, batch)[0][:, -1]
    last = {"forward": forward(params, cfg, batch)[0][:, -1].float(),
            "prefill": logits[:, 0].float(),
            "prefill_fp32": prefill_forward(p32, cfg, batch)[0][:, 0]}
    scale = float(ref.abs().max())
    gap = lambda a, b: float((a - b).abs().max()) / scale
    gaps = {"forward_vs_fp32": gap(last["forward"], ref),
            "prefill_vs_fp32": gap(last["prefill"], ref),
            "forward_vs_prefill": gap(last["forward"], last["prefill"]),
            "fp32_forward_vs_prefill": gap(ref, last["prefill_fp32"])}
    del p32, ref, last
    toks, gen_s = greedy(cfg, params, logits, state, GEN_TOKENS - 1)
    del state
    serve_s, served = serve_requests(cfg, params, seed=2)
    emit("xlstm_serve", prefill_batch=XLSTM_SERVE_B,
         prefill_seq=XLSTM_SERVE_S, prefill_s=prefill_s,
         prefill_tokens_per_s=XLSTM_SERVE_B * XLSTM_SERVE_S / prefill_s,
         last_logit_gap=gaps, fp32_max_logit=scale,
         decode_steps=GEN_TOKENS - 1, decode_s=gen_s,
         decode_tokens_per_s=XLSTM_SERVE_B * (GEN_TOKENS - 1) / gen_s,
         first_tokens=toks[0, :8].tolist(), engine_s=serve_s, **served)

    def line(name, source, replaces, case):
        b, s, h, hd = case["shape"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": case["max_err"], "ms": case["kernel_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": None,
                "per": f"one launch at B {b}, S {s}, H {h}, D {hd}, "
                       f"{case['dtype']} ({launches[name]} a forward)"}

    return [line("mlstm_chunk", "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                 "src/repro/kernels/mlstm_chunk.py:26", main_m),
            line("slstm_step_scan",
                 "src/repro_torch/kernels/csrc/slstm_step.cu",
                 "src/repro/kernels/slstm_step.py:24", main_s)]


def rgemma_phases(gen):
    """The recurrentgemma slice: the RG-LRU kernel against its plain
    version, flash attention at the model's shape, a small end-to-end
    check, the full-width prefill through both kernels, decode from its
    state and the engine.  Returns the kernels line's entries for flash
    attention at this model's shape and for the RG-LRU scan."""
    import torch
    from repro_torch.configs import concrete_batch, get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import (init_model, model_spec,
                                                prefill_forward)

    cfg = get_config("recurrentgemma-2b")
    r, hd = cfg.resolved_d_rnn, cfg.resolved_head_dim

    # ------------------------------------------------- RG-LRU kernel
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        # the shapes of tests/test_kernels.py, then ragged S and R: odd R
        # (one channel a lane, in registers), R even but rows not whole
        # 16-byte units (pairs in registers), S 1, S not a multiple of the
        # 128-step segment at the model's R, and a pointer one channel
        # into its buffer
        for s, rr, off in [(256, 128, 0), (512, 256, 0), (128, 384, 0),
                           (200, 200, 0), (37, 77, 0), (300, 33, 0),
                           (300, 2562, 0), (1, r, 0), (1000, r, 0),
                           (300, r, 1)]:
            cases.append(rglru_case(rglru_scan, rglru_scan_plain, gen,
                                    2, s, rr, dtype, offset=off))
    main_r = rglru_case(rglru_scan, rglru_scan_plain, gen, PREFILL_B,
                        PREFILL_S, r, torch.bfloat16)
    cases.append(main_r)
    emit("rglru_kernels", cases=cases)

    # --------------------------------- flash attention at this shape
    main_f = kernel_case(flash_attention, flash_attention_plain, gen,
                         PREFILL_B, PREFILL_S, cfg.num_heads,
                         cfg.num_kv_heads, hd, cfg.window_size,
                         torch.bfloat16, 2e-2)
    emit("rgemma_flash", case=main_f)

    # ---------------------------------------------------- small check
    # 3 layers (RG-LRU, RG-LRU, window-32 attention), both kernels
    small = cfg.reduced()
    emit("rgemma_check", config=small.name, **small_check(small))

    # ------------------------------------------------------- prefill
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model_spec(cfg))
    if not 2.4e9 <= n_params <= 3.2e9:
        raise AssertionError(f"recurrentgemma param_count {n_params}")
    batch = concrete_batch(cfg, PREFILL_B, PREFILL_S, device="cuda")
    prefill_forward(params, cfg, batch)          # warm-up (cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = rglru_scan.launches = 0
    t0 = time.perf_counter()
    logits, pstate = prefill_forward(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"rglru_scan": rglru_scan.launches,
                "flash_attention": flash_attention.launches}
    kinds = cfg.layer_types()
    expected = {"rglru_scan": kinds.count("rglru"),
                "flash_attention": kinds.count("swa")}
    if launches != expected or expected != {"rglru_scan": 18,
                                            "flash_attention": 8}:
        raise AssertionError(f"recurrentgemma prefill launches {launches}, "
                             f"expected {expected}")
    if logits.shape != (PREFILL_B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("recurrentgemma prefill logits not finite / "
                             "wrong shape")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # every layer's kernel output against its plain version on the
    # model's own activations, elementwise: the RG-LRU to the kernel
    # cases' bf16 bound; flash attention as comparing_attention says
    layer_err = {"rglru_scan": [], "flash_attention": []}
    prefill_forward(params, cfg, batch, opts={
        "rglru_scan": comparing(layer_err["rglru_scan"], rglru_scan,
                                rglru_scan_plain,
                                atol=RGLRU_TOL["bfloat16"], rtol=RGLRU_RTOL),
        "attn_fn": comparing_attention(layer_err["flash_attention"],
                                       flash_attention,
                                       flash_attention_plain, 2e-2)})
    for name, errs in layer_err.items():
        if len(errs) != expected[name] or max(errs) > 1.0:
            raise AssertionError(f"{name} per-layer error {errs}, bound 1")
    emit("rgemma_prefill", config=cfg.name, param_count=n_params,
         batch=PREFILL_B, seq=PREFILL_S, init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_s,
         launches=launches, layer_err=layer_err,
         layer_err_means={
             "rglru_scan": f"max |out-ref|/({RGLRU_TOL['bfloat16']} + "
                           f"{RGLRU_RTOL}|ref|)",
             "flash_attention": "max |out-ref|/(2e-2 (P|V| + |ref|))"},
         peak_mem_gb=peak_gb)

    # ------------------------------------------------------ generate
    state = seeded_state(cfg, pstate, PREFILL_B, PREFILL_S,
                         PREFILL_S + GEN_TOKENS)
    del pstate
    toks, gen_s = greedy(cfg, params, logits, state, GEN_TOKENS - 1)
    emit("rgemma_generate", tokens=GEN_TOKENS, batch=PREFILL_B,
         decode_steps=GEN_TOKENS - 1, seconds=gen_s,
         tokens_per_s=PREFILL_B * (GEN_TOKENS - 1) / gen_s,
         first_tokens=toks[0, :8].tolist())
    del state

    # --------------------------------------------------------- serve
    serve_s, served = serve_requests(cfg, params, seed=3)
    emit("rgemma_serve", seconds=serve_s, **served)
    del params, logits

    n_swa = expected["flash_attention"]
    flash_line = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches["flash_attention"],
        "max_abs_err": main_f["max_err"],
        "ms": n_swa * main_f["kernel_ms"],
        "plain_ms": n_swa * main_f["plain_ms"],
        "bound_ms": n_swa * main_f["bound_ms"],
        "bound_by": main_f["bound_by"],
        "library_ms": n_swa * main_f["library_ms"],
        "per": f"one recurrentgemma-2b prefill: {n_swa} window-"
               f"{cfg.window_size} launches at B {PREFILL_B}, S {PREFILL_S}, "
               f"H {cfg.num_heads}, Kv {cfg.num_kv_heads}, D {hd}, bf16"}
    rglru_line = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:22",
        "launches": launches["rglru_scan"],
        "max_abs_err": main_r["max_err"], "ms": main_r["kernel_ms"],
        "plain_ms": main_r["plain_ms"], "bound_ms": main_r["bound_ms"],
        "bound_by": main_r["bound_by"], "library_ms": None,
        "per": f"one launch at B {PREFILL_B}, S {PREFILL_S}, R {r}, bf16 "
               f"({launches['rglru_scan']} a recurrentgemma-2b prefill)"}
    return [flash_line, rglru_line]


def moe_check():
    """One block of olmoe-1b-7b's MoE FFN at full width (d 2048, E 64,
    top-8, d_ff_expert 1024) on the card against the CPU, B 2 x S 256.

    fp32, x on a grid of 2^-2 and the router on one of 2^-12: every
    partial sum of x @ router is exact, so both devices route from the
    same logits, in which ties are frequent.  The routes (top-k in order,
    the token of every slot, where every (token, k) pair landed) must be
    equal, the gate weights within ``MOE_W_ATOL`` and the output within
    ``MOE_FP32_RTOL`` of its largest value; then the same with the router
    zeroed (every probability equal: experts 0..7 for every token, each
    over capacity).  bf16, at the prefill's B 4 x S 4096: two runs on the
    card bit-equal (the combine adds in a fixed order, no atomics), and
    the routing and the whole FFN timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    cfg = get_config("olmoe-1b-7b")
    k, b, s = cfg.moe.top_k, MOE_CHECK_B, MOE_CHECK_S
    cap = moe.moe_capacity(cfg, s)
    gen = torch.Generator().manual_seed(0)
    p = init_params(moe.moe_spec(cfg), seed=0, device="cpu")
    p["router"] = torch.round(p["router"] * 2 ** 12) / 2 ** 12
    x = torch.round(torch.randn(b, s, cfg.d_model, generator=gen) * 4
                    ).clamp(-16, 16) / 4
    out = {"batch": b, "seq": s, "capacity": cap}
    for name, router in (("grid", p["router"]),
                         ("zero_router", torch.zeros_like(p["router"]))):
        pc = dict(p, router=router)
        pg = {n: t.cuda() for n, t in pc.items()}
        rc, rg = moe.route(pc, x, cfg, cap), moe.route(pg, x.cuda(), cfg, cap)
        for field in ("top_idx", "tok_of_slot", "slot_of_pair"):
            if not torch.equal(getattr(rc, field), getattr(rg, field).cpu()):
                raise AssertionError(f"moe_check {name}: {field} differs "
                                     "between the card and the CPU")
        if name == "zero_router" and not bool(
                (rc.top_idx == torch.arange(k)).all()):
            raise AssertionError("moe_check: a zeroed router must pick "
                                 "experts 0..k-1")
        w_err = float((rg.w_of_slot.cpu() - rc.w_of_slot).abs().max())
        yc = moe.moe_ffn(pc, x, cfg)[0]
        yg = moe.moe_ffn(pg, x.cuda(), cfg)[0].cpu()
        rel = float((yg - yc).abs().max() / yc.abs().max())
        if w_err > MOE_W_ATOL or rel > MOE_FP32_RTOL:
            raise AssertionError(f"moe_check {name}: gate weights {w_err} "
                                 f"(bound {MOE_W_ATOL}), output {rel} "
                                 f"(bound {MOE_FP32_RTOL})")
        top = torch.sort(torch.softmax((x @ router).float(), -1), -1,
                         descending=True)[0][..., :k + 1]
        out[name] = {
            "routes_equal": True, "w_of_slot_max_err": w_err,
            "out_rel_err": rel,
            "tokens_with_a_tie_in_top_k_plus_1": int(
                (top[..., 1:] == top[..., :-1]).any(-1).sum()),
            "dropped_share": float((rc.slot_of_pair < 0).float().mean())}
    del pg, yg, rg
    pb = {n: t.to("cuda", torch.bfloat16) for n, t in p.items()}
    xb = torch.randn(PREFILL_B, PREFILL_S, cfg.d_model,
                     generator=gen).to("cuda", torch.bfloat16)
    y1, y2 = moe.moe_ffn(pb, xb, cfg)[0], moe.moe_ffn(pb, xb, cfg)[0]
    if not torch.equal(y1, y2):
        raise AssertionError("moe_check: two bf16 runs on the card differ")
    big_cap = moe.moe_capacity(cfg, PREFILL_S)
    n_pairs = PREFILL_B * PREFILL_S * k
    expert_flops = (6.0 * PREFILL_B * cfg.moe.num_experts * big_cap
                    * cfg.d_model * cfg.moe.d_ff_expert)
    out["bf16_prefill_shape"] = {
        "batch": PREFILL_B, "seq": PREFILL_S, "capacity": big_cap,
        "bit_equal_runs": True,
        "route_ms": time_ms(lambda: moe.route(pb, xb, cfg, big_cap), runs=5),
        "moe_ffn_ms": time_ms(lambda: moe.moe_ffn(pb, xb, cfg), runs=5),
        "expert_flops_with_padding": expert_flops,
        "expert_bound_ms": expert_flops / PEAK_FLOPS["bfloat16"] * 1e3,
        "routed_pairs": n_pairs}
    out["tol"] = {"w_of_slot": MOE_W_ATOL, "out_rel": MOE_FP32_RTOL}
    return out


def moe_drops(cfg, params, batch):
    """The share of (token, k) pairs dropped at capacity in each layer
    of one prefill, read from the routes ``moe_ffn`` computes."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import prefill_forward
    shares, route = [], moe.route

    def recording(*args):
        r = route(*args)
        shares.append(float((r.slot_of_pair < 0).float().mean()))
        return r
    moe.route = recording
    try:
        prefill_forward(params, cfg, batch)
    finally:
        moe.route = route
    torch.cuda.synchronize()
    return shares


def prefill_flops(cfg, b, s):
    """FLOPs of one MoE prefill: the attention projections, flash
    attention's live pairs, the router and every expert's whole slab
    (padding slots included), as the model computes them."""
    from repro_torch.models.moe import moe_capacity
    d, hd = cfg.d_model, cfg.resolved_head_dim
    proj = 2.0 * b * s * d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    attn = 4.0 * hd * live_pairs(s, 0) * b * cfg.num_heads
    m = cfg.moe
    experts = (6.0 * b * m.num_experts * moe_capacity(cfg, s) * d
               * m.d_ff_expert)
    router = 2.0 * b * s * d * m.num_experts
    return cfg.num_layers * (proj + attn + experts + router)


def olmoe_phases(gen):
    """The MoE slice: flash attention at olmoe-1b-7b's shape, the MoE FFN
    on the card against the CPU, the full-width prefill through flash
    attention in all 16 layers, decode from its caches, the engine and
    ``measure_serve_step_time``.  Returns the kernels line's entry for
    flash attention at this model's shape."""
    import torch
    from repro_torch.configs import concrete_batch, get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import (init_model, model_spec,
                                                prefill_forward)
    from repro_torch.serving.profile import measure_serve_step_time

    cfg = get_config("olmoe-1b-7b")
    hd = cfg.resolved_head_dim
    main_f = kernel_case(flash_attention, flash_attention_plain, gen,
                         PREFILL_B, PREFILL_S, cfg.num_heads,
                         cfg.num_kv_heads, hd, 0, torch.bfloat16, 2e-2)
    emit("olmoe_flash", case=main_f)
    emit("moe_check", **moe_check())
    torch.cuda.empty_cache()

    # ------------------------------------------------------- prefill
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model_spec(cfg))
    if not 6.4e9 <= n_params <= 7.4e9:
        raise AssertionError(f"olmoe param_count {n_params}")
    batch = concrete_batch(cfg, PREFILL_B, PREFILL_S, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill_forward(params, cfg, batch)          # warm-up (cuBLAS)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, pstate = prefill_forward(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = flash_attention.launches
    if launches != cfg.num_layers or cfg.num_layers != 16:
        raise AssertionError(f"olmoe prefill: {launches} flash launches, "
                             f"expected 16")
    if logits.shape != (PREFILL_B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("olmoe prefill logits not finite / wrong shape")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layer_err = []
    prefill_forward(params, cfg, batch, opts={
        "attn_fn": comparing_attention(layer_err, flash_attention,
                                       flash_attention_plain, 2e-2)})
    if len(layer_err) != cfg.num_layers or max(layer_err) > 1.0:
        raise AssertionError(f"olmoe per-layer flash error {layer_err}")
    drops = moe_drops(cfg, params, batch)
    flops = prefill_flops(cfg, PREFILL_B, PREFILL_S)
    emit("olmoe_prefill", config=cfg.name, param_count=n_params,
         batch=PREFILL_B, seq=PREFILL_S, init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_s,
         flash_launches=launches, layer_err=layer_err,
         layer_err_means="max |out-ref|/(2e-2 (P|V| + |ref|))",
         capacity=moe_capacity(cfg, PREFILL_S), dropped_share=drops,
         mean_dropped_share=statistics.mean(drops),
         prefill_flops=flops,
         prefill_bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
         peak_mem_gb=peak_gb)

    # ------------------------------------------------------ generate
    state = seeded_state(cfg, pstate, PREFILL_B, PREFILL_S,
                         PREFILL_S + GEN_TOKENS)
    del pstate
    toks, gen_s = greedy(cfg, params, logits, state, GEN_TOKENS - 1)
    expert_bytes = 2.0 * 3 * cfg.num_layers * cfg.moe.num_experts * \
        cfg.d_model * cfg.moe.d_ff_expert
    emit("olmoe_generate", tokens=GEN_TOKENS, batch=PREFILL_B,
         decode_steps=GEN_TOKENS - 1, seconds=gen_s,
         step_ms=gen_s / (GEN_TOKENS - 1) * 1e3,
         tokens_per_s=PREFILL_B * (GEN_TOKENS - 1) / gen_s,
         expert_bytes_a_step=expert_bytes,
         expert_bytes_bound_ms=expert_bytes / PEAK_BYTES * 1e3,
         first_tokens=toks[0, :8].tolist())
    del state, logits

    # --------------------------------------------------------- serve
    serve_s, served = serve_requests(cfg, params, seed=4)
    del params
    torch.cuda.empty_cache()
    step_s = measure_serve_step_time(cfg, reduce_model=False, device="cuda")
    torch.cuda.empty_cache()
    emit("olmoe_serve", seconds=serve_s, **served,
         measure_serve_step_time_s=step_s,
         measure_serve_step_time_dtype="float32")

    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches, "max_abs_err": main_f["max_err"],
        "ms": launches * main_f["kernel_ms"],
        "plain_ms": launches * main_f["plain_ms"],
        "bound_ms": launches * main_f["bound_ms"],
        "bound_by": main_f["bound_by"],
        "library_ms": launches * main_f["library_ms"],
        "per": f"one olmoe-1b-7b prefill: {launches} global launches at "
               f"B {PREFILL_B}, S {PREFILL_S}, H {cfg.num_heads}, "
               f"Kv {cfg.num_kv_heads}, D {hd}, bf16"}


def kernel_wrappers():
    from repro_torch.kernels.ops import (flash_attention, mlstm_chunk,
                                         rglru_scan, slstm_step_scan)
    return {"flash_attention": flash_attention, "mlstm_chunk": mlstm_chunk,
            "rglru_scan": rglru_scan, "slstm_step_scan": slstm_step_scan}


def check_no_launches(phase):
    launches = {k: f.launches for k, f in kernel_wrappers().items()}
    if any(launches.values()):
        raise AssertionError(f"{phase}: training launched kernels {launches}")
    return launches


def max_leaf_diff(a, b):
    """Largest |a - b| over the leaves of two trees, and its leaf."""
    from repro_torch.models.params import tree_leaves_with_paths
    worst = (0.0, "")
    for (path, x), (_, y) in zip(tree_leaves_with_paths(a),
                                 tree_leaves_with_paths(b)):
        d = float((x.float().cpu() - y.float().cpu()).abs().max())
        worst = max(worst, (d, "/".join(path)))
    return worst


def steps_on_cpu_and_card(cfg, params):
    """One fp32 train step of ``cfg`` through ``BuiltJob`` at ``ddp`` on
    the CPU and on the card, from the same CPU ``params`` and SyntheticLM
    batch.  Returns {device: (params, opt, metrics)}."""
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.params import tree_map
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.parallelism.build import BuiltJob
    batch = next(SyntheticLM(cfg, seed=0).batches(CHECK_B, CHECK_S,
                                                  device="cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        job = BuiltJob(cfg, ParallelismLibrary().get("ddp").plan(cfg, 1),
                       AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100),
                       device=dev)
        # a copy on each device: the step updates its parameters in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        out[dev] = job.step(p, init_opt_state(p), job.place_batch(batch))
    return out


def step_errors(out):
    """Loss and grad_norm |cuda - cpu| / |cpu|."""
    (_, _, mc), (_, _, mg) = out["cpu"], out["cuda"]
    return {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
            for k in ("loss", "grad_norm")}


def train_check():
    """One fp32 train step of xlstm-125m.reduced() on the card and on the
    CPU from the same parameters and SyntheticLM batch."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("xlstm-125m").reduced()
    out = steps_on_cpu_and_card(cfg, init_model(cfg, seed=3, device="cpu"))
    (pc, oc, mc), (pg, og, mg) = out["cpu"], out["cuda"]
    param_err, leaf = max_leaf_diff(pg, pc)
    err = {**step_errors(out), "params": param_err}
    if any(err[k] > TRAIN_CHECK_TOL[k] for k in err) or \
            int(og["step"]) != 1:
        raise AssertionError(f"train_check: CUDA step against CPU step {err} "
                             f"(worst leaf {leaf}), bound {TRAIN_CHECK_TOL}")
    return {"config": cfg.name, "batch": CHECK_B, "seq": CHECK_S,
            "err": err, "worst_param_leaf": leaf, "tol": TRAIN_CHECK_TOL,
            "err_means": "loss, grad_norm: |cuda - cpu| / |cpu|; params: "
                         "max |cuda - cpu| after the step",
            "loss": {"cuda": float(mg["loss"]), "cpu": float(mc["loss"])}}


def moe_train_check():
    """One fp32 train step of olmoe-1b-7b.reduced() (cross-entropy plus
    the MoE aux loss) on the card and on the CPU, as ``train_check``.

    wq, wk and wv are rescaled to a fan-in of d_model, as the CPU parity
    tests do (tests/test_torch_model.py): on the raw init a 1e-7 relative
    change of the parameters alone moves the gradients by 3e-4 of their
    scale (measured on the CPU).  AdamW's first step moves a parameter by
    lr * g / (|g| + eps): where a gradient cancels to |g| ~ eps (on the
    CPU one element of wk had g = 1.5e-9, and -7.4e-10 after that 1e-7
    change, rescaled), one ulp of it moves the parameter by up to lr.
    So the parameters are held at ``TRAIN_CHECK_TOL`` where |g| >= 100
    eps on the CPU, every element's error is reported, and the gradients
    themselves (the first moment, (1 - b1) g, after the step) are held
    leafwise relative to their largest value at the grad_norm
    tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import (tree_leaves_with_paths,
                                           tree_map_with_path)
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config("olmoe-1b-7b").reduced()
    heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads,
             "wv": cfg.num_kv_heads}
    params = tree_map_with_path(
        lambda path, t: t * math.sqrt(heads[path[-1]] / cfg.d_model)
        if path[-1] in heads else t, init_model(cfg, seed=3, device="cpu"))
    out = steps_on_cpu_and_card(cfg, params)
    (pc, oc, mc), (pg, og, mg) = out["cpu"], out["cuda"]
    eps, b1 = AdamWConfig().eps, AdamWConfig().b1
    grad_err, param_err, ill, worst = 0.0, 0.0, 0, max_leaf_diff(pg, pc)
    for (_, muc), (_, mug), (_, xc), (_, xg) in zip(
            tree_leaves_with_paths(oc["mu"]), tree_leaves_with_paths(og["mu"]),
            tree_leaves_with_paths(pc), tree_leaves_with_paths(pg)):
        mug = mug.cpu()
        grad_err = max(grad_err, float((mug - muc).abs().max()
                                       / muc.abs().max().clamp_min(1e-30)))
        g = muc.abs() / (1 - b1)
        sound = g >= 100 * eps
        ill += int(((g > 0) & ~sound).sum())
        param_err = max(param_err, float(
            ((xg.cpu() - xc).abs() * sound).max()))
    err = {**step_errors(out), "grads": grad_err, "params": param_err}
    tol = {**TRAIN_CHECK_TOL, "grads": TRAIN_CHECK_TOL["grad_norm"]}
    if any(err[k] > tol[k] for k in err) or int(og["step"]) != 1 or \
            not float(mg["aux_loss"]) > 0.0:
        raise AssertionError(f"moe_train_check: CUDA step against CPU step "
                             f"{err}, bound {tol}")
    n = sum(t.numel() for _, t in tree_leaves_with_paths(pc))
    return {"config": cfg.name, "batch": CHECK_B, "seq": CHECK_S,
            "err": err, "tol": tol,
            "err_means": "loss, grad_norm: |cuda - cpu| / |cpu|; grads: "
                         "max |cuda - cpu| / max |cpu| of each leaf's first "
                         "moment; params: max |cuda - cpu| after the step "
                         "where |g| >= 100 eps",
            "params_err_everywhere": worst[0], "worst_param_leaf": worst[1],
            "elements_with_0_lt_g_lt_100_eps": ill, "elements": n,
            "loss": {"cuda": float(mg["loss"]), "cpu": float(mc["loss"])},
            "aux_loss": {"cuda": float(mg["aux_loss"]),
                         "cpu": float(mc["aux_loss"])}}


def host_cfg():
    """xlstm-125m at full width cut to ``HOST_LAYERS`` layers: its steps
    are host-bound (the sLSTM's step loop), so a step's time scales with
    the depth."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("xlstm-125m"),
                               num_layers=HOST_LAYERS,
                               name=f"xlstm-125m-{HOST_LAYERS}l")


def timed_steps(step, params, opt, batches):
    """Run ``step`` over ``batches``; returns (params, opt, per-step
    seconds, losses, grad norms)."""
    import torch
    secs, losses, norms = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"non-finite loss or grad_norm: {losses} {norms}")
    return params, opt, secs, losses, norms


def device_busy(step, params, opt, batch):
    """One train step under torch.profiler (device activity only): the
    step's wall time, the summed time of the device work it ran (kernels,
    copies and sets on one stream, so they do not overlap) and their
    ratio, the device's busy share.  Profiling adds a little to the wall
    time, so the share is if anything low.  None where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the raw events: key_averages() takes tens of seconds on 0.6 M
    by_name, count = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
            count += 1
    busy = sum(by_name.values()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"profiled_step_s": wall, "device_busy_s": busy or None,
            "device_busy_share": busy / wall if busy else None,
            "device_events": count,
            "top_device_s": {k[:60]: v / 1e9 for k, v in top}}


def train_step_phase():
    """xlstm-125m at full width and ``HOST_LAYERS`` layers, fp32, B 8 x S
    512 through BuiltJob at ddp and remat-offload (one device each), then
    two steps with the batched-gradient sLSTM scan."""
    import torch
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.train.steps import lm_loss, make_train_step
    cfg = host_cfg()
    lib = ParallelismLibrary()
    # the launcher's schedule for a 100-step run
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    batches = list(SyntheticLM(cfg, seed=0).batches(
        TRAIN_B, TRAIN_S, num_batches=1 + max(TRAIN_STEPS.values()),
        device="cuda"))
    out = {}
    for tech in ("ddp", "remat-offload"):
        job = BuiltJob(cfg, lib.get(tech).plan(cfg, 1), opt_cfg,
                       device="cuda")
        params, opt = job.init(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt, secs, losses, norms = timed_steps(
            job.step, params, opt,
            map(job.place_batch, batches[:1 + TRAIN_STEPS[tech]]))
        s_step = statistics.median(secs[1:]) if secs[1:] else None
        if tech == "ddp":
            # the step's forward alone (the loss, no autograd graph), and
            # how busy one more step keeps the device
            t0 = time.perf_counter()
            lm_loss(params, cfg, batches[0])
            torch.cuda.synchronize()
            forward_s = time.perf_counter() - t0
            busy = device_busy(job.step, params, opt, batches[0])
        out[tech] = {"remat": job.plan.remat, "warmup_s": secs[0],
                     "step_s": secs[1:], "median_step_s": s_step,
                     "tokens_per_s": TRAIN_B * TRAIN_S / s_step
                     if s_step else None,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "loss": losses, "grad_norm": norms}
        del params, opt
        torch.cuda.empty_cache()
    out["ddp"].update(forward_s=forward_s, **busy)
    job = BuiltJob(cfg, lib.get("ddp").plan(cfg, 1), opt_cfg, device="cuda")
    params, opt = job.init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, opt_cfg, opts={"slstm_batched_grad": True})
    params, opt, secs, losses, norms = timed_steps(step, params, opt,
                                                   batches[:2])
    out["ddp_slstm_batched_grad"] = {
        "warmup_s": secs[0], "step_s": secs[1:], "median_step_s": secs[1],
        "tokens_per_s": TRAIN_B * TRAIN_S / secs[1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": losses, "grad_norm": norms}
    if abs(losses[0] - out["ddp"]["loss"][0]) > 1e-4 * abs(losses[0]):
        raise AssertionError("the batched-gradient step's first loss "
                             f"{losses[0]} is not the ddp step's "
                             f"{out['ddp']['loss'][0]}")
    del params, opt
    torch.cuda.empty_cache()
    return {"config": cfg.name, "dtype": "float32", "batch": TRAIN_B,
            "seq": TRAIN_S, "steps": out}


def resume_child(workdir):
    """Child of phase ``train_resume``: with deterministic algorithms on,
    4 straight steps against 2 steps, a checkpoint, ``load_training_state``
    and 2 more steps from ``skip=2``.  Prints one JSON line; exits 1
    unless the losses and the final state are bit-equal."""
    import torch
    torch.use_deterministic_algorithms(True)
    from repro_torch.checkpoint.store import (load_training_state,
                                              save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.params import tree_leaves_with_paths
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    cfg = get_config("xlstm-125m").reduced()
    job = BuiltJob(cfg, ParallelismLibrary().get("ddp").plan(cfg, 1),
                   AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                   device="cuda")
    data = SyntheticLM(cfg, seed=0)

    def run(params, opt, skip, n):
        losses = []
        for b in data.batches(CHECK_B, CHECK_S, num_batches=n, skip=skip,
                              device="cuda"):
            params, opt, m = job.step(params, opt, b)
            losses.append(float(m["loss"]))
        return params, opt, losses

    straight = run(*job.init(0), 0, 4)
    params, opt, first = run(*job.init(0), 0, 2)
    path = str(Path(workdir) / "resume.npz")
    save_checkpoint(path, {"params": params, "opt": opt},
                    {"step": 2, "loss": first[-1]})
    params, opt, start = load_training_state(path, *job.init(0))
    resumed = run(params, opt, start, 2)
    equal = {"/".join(p): bool(torch.equal(x, y)) for (p, x), (_, y) in zip(
        tree_leaves_with_paths(straight[:2]), tree_leaves_with_paths(
            resumed[:2]))}
    ok = start == 2 and straight[2][2:] == resumed[2] and all(equal.values())
    print(json.dumps({"start_step": start, "straight_loss": straight[2],
                      "resumed_loss": first + resumed[2],
                      "leaves": len(equal),
                      "unequal": [k for k, v in equal.items() if not v]}))
    return 0 if ok else 1


def train_resume():
    import os
    workdir = Path(__file__).resolve().parent / "build" / "train_resume"
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--resume-child", str(workdir)], env=env,
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        raise AssertionError(f"train_resume child exited {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-4000:]}")
    return {"config": "xlstm-125m-smoke", "batch": CHECK_B, "seq": CHECK_S,
            "deterministic": True, "bit_equal": True,
            **json.loads(lines[-1])}


def train_cli():
    """``python -m repro_torch.launch.train`` at full width for
    ``CLI_STEPS`` steps at S ``SATURN_S`` (train_step times S
    ``TRAIN_S``); its checkpoint must verify."""
    import os
    from repro_torch.checkpoint.store import verify_checkpoint
    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "train_cli" / "ck.npz"
    for stale in ckpt.parent.glob("ck.npz*"):
        stale.unlink()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "xlstm-125m", "--technique", "ddp", "--devices", "1", "--steps",
           str(CLI_STEPS), "--batch", str(TRAIN_B), "--seq", str(SATURN_S),
           "--log-every", "1", "--ckpt", str(ckpt)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=str(root / "src")),
                       cwd=root, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"launch.train exited {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-4000:]}")
    steps = [ln for ln in r.stdout.splitlines() if ln.startswith("step")]
    meta = verify_checkpoint(str(ckpt))
    if len(steps) != CLI_STEPS or meta.get("step") != CLI_STEPS:
        raise AssertionError(f"launch.train: {steps} {meta}")
    return {"command": " ".join(cmd[1:]), "returncode": r.returncode,
            "seconds": seconds, "step_lines": steps,
            "checkpoint_verified": True, "checkpoint_step": meta["step"],
            "checkpoint_mb": ckpt.stat().st_size / 1e6}


def train_phases():
    """The training phases; the four kernel counters stay at 0."""
    for f in kernel_wrappers().values():
        f.launches = 0
    emit("train_check", **train_check())
    emit("moe_train_check", **moe_train_check(),
         kernel_launches=check_no_launches("moe_train_check"))
    emit("train_step", **train_step_phase(),
         kernel_launches=check_no_launches("train_step"))
    emit("train_resume", **train_resume())
    emit("train_cli", **train_cli())
    check_no_launches("training")


# ------------------------------------------------- process groups

def groups_of_one(phase, plans, after=None):
    """For each (plan, its no-group plan) of ``plans(cfg)`` (by name), on
    xlstm-125m at full width and ``HOST_LAYERS`` layers, fp32, B 8 x S
    128: PAR_STEPS steps through the multi-device BuiltJob as rank 0 of
    a world-size-1 NCCL group and through the no-group BuiltJob from the
    same seed and batches; losses, grad norms and every parameter
    bit-equal.  Times the group's set-up: init (with ``device_id`` bound
    NCCL builds its communicator there) and the first collective.
    ``after(group, cfg, batch)``, where given, runs in the group last,
    and its dict joins the result."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.params import tree_leaves_with_paths
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.parallelism.dist import (file_store, init_group,
                                              nccl_version)
    cfg = host_cfg()
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    batches = list(SyntheticLM(cfg, seed=0).batches(
        SATURN_B, SATURN_S, num_batches=PAR_STEPS, device="cuda"))
    d = saturn_dir(phase)
    t0 = time.perf_counter()
    group = init_group(0, 1, file_store(str(d)), torch.device("cuda", 0))
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    first_collective_s = time.perf_counter() - t0
    out = {}
    try:
        for tech, (plan, alone) in plans(cfg).items():
            runs = {}
            for name, grp in (("no_group", None), ("group", group)):
                job = BuiltJob(cfg, plan if grp else alone, opt_cfg,
                               device="cuda", group=grp)
                params, opt = job.init(0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                params, opt, secs, losses, norms = timed_steps(
                    job.step, params, opt, map(job.place_batch, batches))
                runs[name] = {"params": params, "step_s": secs,
                              "loss": losses, "grad_norm": norms,
                              "peak_mem_gb":
                              torch.cuda.max_memory_allocated() / 1e9}
            a, b = runs["no_group"], runs["group"]
            unequal = [
                "/".join(p) for (p, x), (_, y) in zip(
                    tree_leaves_with_paths(a.pop("params")),
                    tree_leaves_with_paths(b.pop("params")))
                if not torch.equal(x, y)]
            if a["loss"] != b["loss"] or a["grad_norm"] != b["grad_norm"] \
                    or unequal:
                raise AssertionError(
                    f"{phase}: {tech} in a group of one is not the "
                    f"no-group step: {a['loss']} {b['loss']} "
                    f"{a['grad_norm']} {b['grad_norm']} {unequal[:5]}")
            out[tech] = {"no_group": a, "group": b,
                         "bit_equal_params_losses": True}
            torch.cuda.empty_cache()
        extra = after(group, cfg, batches[0]) if after is not None else {}
    finally:
        group.destroy()
        saturn_cleanup(d)
    return {"config": cfg.name, "dtype": "float32", "batch": SATURN_B,
            "seq": SATURN_S, "steps": PAR_STEPS, "backend": "nccl",
            "world_size": 1, "nccl_version": nccl_version(),
            "init_process_group_s": init_s,
            "first_collective_s": first_collective_s, "techniques": out,
            **extra}


def par_group1():
    """ddp and remat-offload (:func:`groups_of_one`)."""
    from repro_torch.core.library import ParallelismLibrary
    lib = ParallelismLibrary()

    def plans(cfg):
        return {tech: (lib.get(tech).plan(cfg, 1),) * 2
                for tech in ("ddp", "remat-offload")}
    return groups_of_one("par_group1", plans)


def decode_group1(group, cfg, batch):
    """A prefill of ``batch`` and PAR_DECODE_STEPS greedy decode steps
    from it, under the rules plan on PAR_2D_MESH as rank 0 of ``group``
    (the decode state placed by ``cache_shardings``, every axis of one
    rank) and without a group, from the same fp32 weights: tokens,
    logits and every state leaf bit-equal.  Each side's seconds."""
    import torch
    from repro_torch.launch.mesh import cache_shardings
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import tree_leaves_with_paths
    from repro_torch.models.transformer import (greedy_tokens, init_model,
                                                prefill_forward)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.testing.parallel_check import greedy_decode, rules_plan
    params = init_model(cfg, seed=0, device="cuda")
    b, s = batch["tokens"].shape
    layout, _ = cache_shardings(cfg, InputShape("decode", s, b, "decode"),
                                PAR_2D_MESH, False)
    runs = {}
    for name in ("no_group", "group"):
        job = None if name == "no_group" else BuiltJob(
            cfg, rules_plan(cfg, PAR_2D_MESH), AdamWConfig(), group=group)
        p = params if job is None else job.shard(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            if job is None:
                logits, state = prefill_forward(p, cfg, batch, opts={})
            else:
                with job.running(p):
                    logits, state = prefill_forward(p, cfg, batch, opts={})
        steps, state = greedy_decode(cfg, p, greedy_tokens(logits), state,
                                     PAR_DECODE_STEPS, job,
                                     None if job is None else layout)
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0, "steps": steps,
                      "state": [t for _, t in
                                tree_leaves_with_paths(state["layers"])]}
    a, c = runs["no_group"], runs["group"]
    unequal = [i for i, ((la, ta), (lc, tc)) in enumerate(
        zip(a["steps"], c["steps"]))
        if not (torch.equal(ta, tc) and torch.equal(la, lc))]
    unequal += [f"state {i}" for i, (x, y) in enumerate(
        zip(a["state"], c["state"])) if not torch.equal(x, y)]
    if unequal:
        raise AssertionError(f"decode in a group of one is not the "
                             f"no-group decode: {unequal[:5]}")
    return {"decode": {
        "prefill_batch": b, "prefill_seq": s, "steps": PAR_DECODE_STEPS,
        "tokens": [t[:, 0].tolist() for _, t in c["steps"]],
        "no_group_s": a["seconds"], "group_s": c["seconds"],
        "bit_equal_tokens_logits_state": True},
        "decode_per_row": decode_rows_group1(group)}


def decode_rows_group1(group):
    """PAR_DECODE_STEPS greedy decode steps with each row at its own
    position (``pos`` of shape (B,), as continuous batching decodes),
    under the rules plan on PAR_2D_MESH as rank 0 of ``group`` and
    without a group, on h2o-danube-3-4b reduced to 4 layers (window 32)
    in fp32, from a random state of KV caches of length 64
    (``parallel_check.random_decode_state`` and ``random_positions``,
    rows on both sides of 32) placed by ``cache_shardings`` under the
    "seq" policy: tokens, logits, every state leaf and the positions
    bit-equal.  Each side's seconds."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import cache_shardings
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import tree_leaves_with_paths
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.testing.parallel_check import (
        _decode_state, greedy_decode, random_decode_state, random_positions,
        rules_plan)
    cfg = get_config("h2o-danube-3-4b").reduced(num_layers=4)
    b, n = SATURN_B, 64
    params = init_model(cfg, seed=0, device="cuda")
    state_np = random_decode_state(cfg, b, n, seed=3)
    start = random_positions(b, n, seed=3)
    tokens = torch.as_tensor(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (b, 1)).astype(np.int32), device="cuda")
    layout, _ = cache_shardings(cfg, InputShape("decode", n, b, "decode"),
                                PAR_2D_MESH, False, policy="seq")
    runs = {}
    for name in ("no_group", "group"):
        job = None if name == "no_group" else BuiltJob(
            cfg, rules_plan(cfg, PAR_2D_MESH), AdamWConfig(), group=group)
        p = params if job is None else job.shard(params)
        state = _decode_state(state_np, start, "cuda")
        if job is not None:
            state = job.shard_state(state, layout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps, state = greedy_decode(cfg, p, tokens, state,
                                     PAR_DECODE_STEPS, job,
                                     None if job is None else layout)
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0, "steps": steps,
                      "pos": state["pos"],
                      "state": [t for _, t in
                                tree_leaves_with_paths(state["layers"])]}
    a, c = runs["no_group"], runs["group"]
    unequal = [i for i, ((la, ta), (lc, tc)) in enumerate(
        zip(a["steps"], c["steps"]))
        if not (torch.equal(ta, tc) and torch.equal(la, lc))]
    unequal += [f"state {i}" for i, (x, y) in enumerate(
        zip(a["state"], c["state"])) if not torch.equal(x, y)]
    want = torch.as_tensor(start + PAR_DECODE_STEPS, device="cuda")
    if not (torch.equal(a["pos"], want) and torch.equal(c["pos"], want)):
        unequal.append("pos")
    if unequal:
        raise AssertionError(f"per-row decode in a group of one is not "
                             f"the no-group decode: {unequal[:5]}")
    return {"config": cfg.name, "batch": b, "cache_len": n,
            "policy": "seq", "start_pos": start.tolist(),
            "steps": PAR_DECODE_STEPS,
            "tokens": [t[:, 0].tolist() for _, t in c["steps"]],
            "no_group_s": a["seconds"], "group_s": c["seconds"],
            "bit_equal_tokens_logits_state_pos": True}


def par_2d_group1():
    """The dry run's rules plan on (data 1, model 1): its mesh of two
    axes and their flattened group, placements, the bucketed gradient
    all-reduce and the batch axes, against the one-device ddp step
    (:func:`groups_of_one`); then its decode (:func:`decode_group1`)."""
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.testing.parallel_check import rules_plan

    def plans(cfg):
        return {"rules": (rules_plan(cfg, PAR_2D_MESH),
                          ParallelismLibrary().get("ddp").plan(cfg, 1))}
    out = groups_of_one("par_2d_group1", plans, after=decode_group1)
    return {"mesh": dict(PAR_2D_MESH), **out}


def dryrun_record(phase, combination):
    """One full-width combination (arch, shape, multi_pod, preset) of the
    multi-pod dry run through ``run_one``: rank 0's step traced on meta
    tensors in a fake group of 256 ranks (host CPU only, no card),
    gated on ``status == "ok"``."""
    from repro_torch.launch.dryrun import run_one
    arch, shape, multi_pod, preset = combination
    rec = run_one(arch, shape, multi_pod, preset=preset, verbose=False)
    if rec["status"] != "ok":
        raise AssertionError(f"{phase}: {rec.get('error', rec)}\n"
                             f"{rec.get('traceback', '')}")
    return rec


def par_phases(smi):
    """The process-group phases; the four kernel counters stay at 0."""
    for f in kernel_wrappers().values():
        f.launches = 0
    emit("par_group1", nvidia_smi=smi, **par_group1(),
         kernel_launches=check_no_launches("par_group1"))
    emit("par_2d_group1", nvidia_smi=smi, **par_2d_group1(),
         kernel_launches=check_no_launches("par_2d_group1"))
    emit("dryrun_one", **dryrun_record("dryrun_one", DRYRUN_ONE),
         kernel_launches=check_no_launches("dryrun_one"))
    emit("dryrun_decode",
         records=[dryrun_record("dryrun_decode", c) for c in DRYRUN_DECODE],
         kernel_launches=check_no_launches("dryrun_decode"))


# ------------------------------------------------------- Saturn's loop

def saturn_dir(name):
    """A fresh checkpoint directory under build/saturn/ (git-ignored)."""
    import shutil
    d = Path(__file__).resolve().parent / "build" / "saturn" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def saturn_cleanup(d):
    import shutil
    import torch
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def saturn_lib():
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.parallelism.techniques import DDP, RematOffload
    return ParallelismLibrary([DDP(), RematOffload()])


def saturn_job(name, steps, lr=1e-3, seed=0):
    from repro_torch.core import Job
    return Job(name, host_cfg(), SATURN_B, SATURN_S, total_steps=steps,
               lr=lr, seed=seed)


def steps_for(est, seconds, lo):
    """bench_e2e's sizing: enough steps for ``seconds`` at the measured
    step time ``est``, at least ``lo``."""
    return max(lo, int(seconds / max(est, 1e-4)))


def saturn_profiles(jobs, probes):
    """The probe's trials as each job's profiles (bench_e2e's
    mk_profiles)."""
    from repro_torch.core.profiler import Profile
    return {(j.name, t, 1): Profile(j.name, t, 1, p.step_time_s,
                                    p.mem_per_device, p.feasible, p.source)
            for j in jobs for t, p in probes.items()}


def segments_of(stats):
    return {name: {"segments": [
        {k: seg[k] for k in ("technique", "start_step", "steps", "preempted",
                             "compile_s", "measured_step_s", "first_loss",
                             "last_loss")} for seg in st["segments"]]}
        for name, st in stats.items()}


def saturn_profile(hw):
    """The empirical Trial Runner on a full-width probe job."""
    from repro_torch.core import TrialRunner
    runner = TrialRunner(saturn_lib(), hw, device="cuda")
    probe = saturn_job("probe", 1)
    t0 = time.perf_counter()
    probes = {t: runner.profile(probe, t, 1, mode="empirical")
              for t in ("ddp", "remat-offload")}
    wall = time.perf_counter() - t0
    for t, p in probes.items():
        if not (p.feasible and math.isfinite(p.step_time_s)
                and p.step_time_s > 0):
            raise AssertionError(f"saturn_profile: {t} x1 trial {p}")
    return {"config": probe.cfg.name, "batch": SATURN_B, "seq": SATURN_S,
            "hardware": {"name": hw.name, "flops": hw.flops,
                         "hbm_bw": hw.hbm_bw, "hbm_capacity": hw.hbm_capacity},
            "trials": runner.trials, "wall_s": wall,
            "trial": {t: {"ms_per_step": p.step_time_s * 1e3,
                          "peak_gb": p.terms["peak_mem_bytes"] / 1e9,
                          "mem_estimate_gb": p.mem_per_device / 1e9}
                      for t, p in probes.items()}}, probes, runner


def analysis_line(a, wall_s, capacity):
    return {"flops": a["flops"], "bytes_written": a["bytes_written"],
            "collectives": a["collectives"], "peak_gb": a["peak_bytes"] / 1e9,
            "feasible": a["peak_bytes"] <= capacity, "wall_s": wall_s}


def roofline_jobs():
    """saturn_roofline's jobs: the probe, and a held-out job at twice
    its batch; and gemma3-4b at full depth and the same shape, analysed
    only."""
    from repro_torch.configs import get_config
    from repro_torch.core import Job
    probe = saturn_job("probe", 1)
    held = Job("held_out", probe.cfg, 2 * SATURN_B, SATURN_S,
               total_steps=1, lr=1e-3, seed=1)
    gemma = Job("gemma", get_config("gemma3-4b"), SATURN_B, SATURN_S,
                total_steps=1, lr=1e-3)
    return probe, held, gemma


def from_analysis(runner, job, prof):
    """Whether ``prof`` was predicted from the analysis of its own step
    (the count it scales from is its own, and the runner analysed that
    step)."""
    plan = runner.library.get(prof.technique).plan(job.cfg, prof.n_devices)
    key = runner._shape_key(job, prof.technique, plan.mesh_shape)
    return key in runner.analysis_wall_s and \
        prof.terms.get("hlo_base_n", prof.n_devices) == prof.n_devices


def roofline_loops():
    """The step analyzer on the whole xlstm-125m's ``ddp`` x1 train step
    at B 16 and S 1024 and 2048: both lengths take the chunked mLSTM,
    and with each time loop counted once and charged for its trips the
    analyzer dispatches the same ops at both (gated)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.step_analysis import analyze_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.techniques import DDP
    cfg = get_config("xlstm-125m")
    got = {}
    for seq in (1024, 2048):
        t0 = time.perf_counter()
        a = analyze_train_step(cfg, DDP().plan(cfg, 1), AdamWConfig(),
                               ROOFLINE_LOOPS_B, seq)
        got[str(seq)] = {"wall_s": time.perf_counter() - t0,
                         "dispatched_ops": a["dispatched_ops"],
                         "flops": a["flops"], "peak_gb": a["peak_bytes"] / 1e9}
    ops = {v["dispatched_ops"] for v in got.values()}
    if len(ops) != 1:
        raise AssertionError(f"saturn_roofline_loops: {got}")
    return {"config": cfg.name, "technique": "ddp", "devices": 1,
            "batch": ROOFLINE_LOOPS_B, "by_seq": got}


def saturn_roofline(runner, probes):
    """The roofline strategy on saturn_profile's runner: its two
    empirical x1 trials of the probe (cache hits) are the calibration,
    and every other (technique, count <= 8) of the probe and of a
    held-out job at twice the batch is predicted from one step analysis
    each (a fake process group stands in for the other ranks).  Then
    the held-out job's real x1 trials give each prediction's error and
    the analyzer's peak bytes against the measured peak, and gemma3-4b's
    training step is analysed at every (technique, count <= 8) its
    search space admits, against the card's memory."""
    import torch.distributed as dist
    from repro_torch.core import TrialRunner
    from repro_torch.core.library import ParallelismLibrary
    hw = runner.hw
    probe, held, gemma = roofline_jobs()

    def analysis(r, job, tech, g):
        plan = r.library.get(tech).plan(job.cfg, g)
        a = r._analysis(job, plan)
        key = r._shape_key(job, tech, plan.mesh_shape)
        return a, r.analysis_wall_s[key]

    t0 = time.perf_counter()
    pm = runner.profile_all([probe, held], ROOFLINE_COUNTS, mode="empirical",
                            strategy="roofline", calibration_trials=2,
                            confidence_threshold=0.0)
    wall = time.perf_counter() - t0
    stats = dict(runner.roofline_stats)
    jobs = {j.name: j for j in (probe, held)}
    preds = {"/".join(map(str, k)): pm[k] for k in pm}
    bad = {k: p.step_time_s for k, p in preds.items()
           if not (math.isfinite(p.step_time_s) and p.step_time_s > 0)}
    unanalysed = [k for k, p in preds.items() if p.source == "roofline"
                  and not from_analysis(runner, jobs[p.job], p)]
    if bad or unanalysed or stats["calibration_trials"] != 2:
        raise AssertionError(f"saturn_roofline: {stats} {bad} "
                             f"{unanalysed}")
    held_out = {}
    for t in ("ddp", "remat-offload"):
        pred = pm[("held_out", t, 1)]
        real = runner.profile(held, t, 1, mode="empirical")
        a, _ = analysis(runner, held, t, 1)
        pa, _ = analysis(runner, probe, t, 1)
        held_out[t] = {
            "predicted_ms": pred.step_time_s * 1e3,
            "measured_ms": real.step_time_s * 1e3,
            "rel_err": (pred.step_time_s - real.step_time_s)
            / real.step_time_s,
            "analysis_peak_gb": a["peak_bytes"] / 1e9,
            "measured_peak_gb": real.terms["peak_mem_bytes"] / 1e9,
            "peak_ratio": a["peak_bytes"] / real.terms["peak_mem_bytes"],
            "probe_peak_ratio": pa["peak_bytes"]
            / probes[t].terms["peak_mem_bytes"]}
    every = TrialRunner(ParallelismLibrary(), hw, device="cuda")
    t0 = time.perf_counter()
    gem = {f"{name}/{g}": analysis_line(*analysis(every, gemma, name, g),
                                        hw.hbm_capacity)
           for name, t in every.library.items()
           for g in ROOFLINE_COUNTS if t.search_space(gemma.cfg, g)}
    gemma_s = time.perf_counter() - t0
    if dist.is_initialized():
        raise AssertionError("saturn_roofline: a process group is left")
    return {"config": probe.cfg.name, "seq": SATURN_S,
            "counts": ROOFLINE_COUNTS,
            "jobs": {"probe": SATURN_B, "held_out": held.batch_size},
            "roofline_stats": stats, "profile_all_s": wall,
            "calibration": runner.calibration["default"].to_json(),
            "predicted_ms": {k: p.step_time_s * 1e3 for k, p in preds.items()},
            "sources": {k: p.source for k, p in preds.items()},
            "analysis_wall_s": {
                f"B{k[3]}/{k[5]}/x{k[6][0]}": v
                for k, v in runner.analysis_wall_s.items()},
            "held_out": held_out,
            "gemma3_4b": {"dtype": "float32", "batch": SATURN_B,
                          "seq": SATURN_S, "capacity_gb":
                          hw.hbm_capacity / 1e9, "analyses_s": gemma_s,
                          "analyses": gem}}


def saturn_fidelity(probes):
    """bench_e2e scenario 1 at one device: one SaturnStatic plan of two
    jobs, predicted by the SimBackend and executed for real."""
    from repro_torch.core import ClusterSpec, LocalTorchBackend
    from repro_torch.core.baselines import SaturnStatic
    from repro_torch.core.executor import simulate
    est = probes["ddp"].step_time_s
    cluster = ClusterSpec(nodes=1, gpus_per_node=1, restart_cost_s=1.0)
    jobs = [saturn_job(f"j{i}", steps_for(est, s, 2), lr, i)
            for i, (s, lr) in enumerate([(6.0, 1e-3), (4.0, 3e-4)])]
    profiles = saturn_profiles(jobs, probes)
    predicted = simulate(jobs, SaturnStatic(time_limit_s=10), profiles,
                         cluster, noise_sigma=0.0)
    d = saturn_dir("fidelity")
    be = LocalTorchBackend(library=saturn_lib(), ckpt_dir=str(d))
    t0 = time.perf_counter()
    executed = simulate(jobs, SaturnStatic(time_limit_s=10), profiles,
                        cluster, noise_sigma=0.0, exec_backend=be)
    wall = time.perf_counter() - t0
    saturn_cleanup(d)
    for j in jobs:
        segs = executed.stats[j.name]["segments"]
        if sum(s["steps"] for s in segs) != j.total_steps:
            raise AssertionError(f"saturn_fidelity: {j.name} {segs}")
    ratio = executed.makespan_s / predicted.makespan_s
    if not 0.1 <= ratio <= 8.0:
        raise AssertionError(f"saturn_fidelity: ratio {ratio} out of band")
    # the segments' own step times (warm-up included); the rest of the
    # executed makespan is set-up, checkpoints and the engine
    step_s = sum(s["compile_s"] + (s["steps"] - 1) * (s["measured_step_s"]
                                                      or 0.0)
                 for j in jobs for s in executed.stats[j.name]["segments"])
    return {"jobs": {j.name: j.total_steps for j in jobs},
            "predicted_s": predicted.makespan_s,
            "executed_s": executed.makespan_s, "ratio": ratio,
            "executed_step_s": step_s,
            "executed_other_s": executed.makespan_s - step_s,
            "compile_total_s": sum(s["compile_s"] for j in jobs
                                   for s in executed.stats[j.name]
                                   ["segments"]),
            "solver": executed.stats.get("solver"),
            "wall_s": wall,
            **segments_of({j.name: executed.stats[j.name] for j in jobs})}


def flip_policy(target, total):
    """bench_e2e's FlipWhenProgressed at one device: ``target`` moves
    from ddp x1 to remat-offload x1 at the first replan that sees it
    progress."""
    from repro_torch.core.schedule import Policy, Schedule, ScheduleEntry

    class FlipWhenProgressed(Policy):
        name = "flip"
        dynamic = True
        replan_on_completion = False

        def __init__(self):
            self.flipped = False

        def plan(self, jobs_, remaining, _profiles, _cluster, current):
            if remaining.get(target, total) < total:
                self.flipped = True
            return Schedule([ScheduleEntry(
                j.name, "remat-offload" if j.name == target and self.flipped
                else "ddp", 1) for j in jobs_])

    return FlipWhenProgressed()


def straight_losses(job, segs):
    """``job`` trained straight through BuiltJob, each segment's steps at
    its technique, parameters kept on the card across the boundaries."""
    import torch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.parallelism.build import BuiltJob
    lib = saturn_lib()
    built = {t: BuiltJob(job.cfg, lib.get(t).plan(job.cfg, 1), job.opt_cfg,
                         device="cuda")
             for t in {s["technique"] for s in segs}}
    params, opt = built[segs[0]["technique"]].init(job.seed)
    data = SyntheticLM(job.cfg, seed=job.seed).batches(
        job.batch_size, job.seq_len, num_batches=job.total_steps,
        device="cuda")
    losses = []
    for seg in segs:
        b = built[seg["technique"]]
        for _ in range(seg["steps"]):
            params, opt, m = b.step(params, opt, next(data))
            losses.append(float(m["loss"]))
    del params, opt
    torch.cuda.empty_cache()
    return losses


def saturn_restart(probes):
    """bench_e2e scenario 2 at one device: an introspection replan
    preempts the training j0, which checkpoints, pays the restart penalty
    and resumes from its step with the data stream continued."""
    from repro_torch.core import ClusterSpec, LocalTorchBackend
    from repro_torch.core.executor import simulate
    est = probes["ddp"].step_time_s
    cluster = ClusterSpec(nodes=1, gpus_per_node=1, restart_cost_s=1.0)
    long_steps = steps_for(est, 8.0, 4)
    jobs = [saturn_job("j0", long_steps), saturn_job("j1", 2, seed=1)]
    d = saturn_dir("restart")
    be = LocalTorchBackend(library=saturn_lib(), ckpt_dir=str(d))
    t0 = time.perf_counter()
    res = simulate(jobs, flip_policy("j0", long_steps),
                   saturn_profiles(jobs, probes), cluster, noise_sigma=0.0,
                   introspect_every_s=2.0 * est, exec_backend=be)
    wall = time.perf_counter() - t0
    saturn_cleanup(d)
    segs = res.stats["j0"]["segments"]
    for a, b in zip(segs, segs[1:]):
        if b["start_step"] != a["start_step"] + a["steps"]:
            raise AssertionError(f"saturn_restart: resume broke the chain "
                                 f"{segs}")
    if res.restarts < 1 or len(segs) < 2 or segs[0]["steps"] <= 0 or \
            sum(s["steps"] for s in segs) != long_steps or \
            segs[-1]["technique"] != "remat-offload":
        raise AssertionError(f"saturn_restart: restarts {res.restarts}, "
                             f"segments {segs}")
    losses = [v for _, v in res.stats["j0"]["losses"]]
    if not all(map(math.isfinite, losses)) or not be.observed:
        raise AssertionError(f"saturn_restart: losses {losses}, observed "
                             f"{be.observed}")
    straight = straight_losses(jobs[0], segs)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, straight)]
    if len(straight) != len(losses) or max(rel) > SATURN_LOSS_RTOL:
        raise AssertionError(f"saturn_restart: segmented losses {losses} "
                             f"against straight {straight}")
    restart_s = [g.end_s - g.start_s for g in res.gantt
                 if g.kind == "restart"]
    return {"long_steps": long_steps, "restarts": res.restarts,
            "replans": res.replans, "makespan_s": res.makespan_s,
            "wall_s": wall, "restart_penalty_s": restart_s,
            "resumed_step": segs[1]["start_step"],
            "observed": {"/".join(map(str, k)): v
                         for k, v in be.observed.items()},
            "losses": losses, "straight_losses": straight,
            "max_rel_loss_err": max(rel), "rtol": SATURN_LOSS_RTOL,
            **segments_of({j.name: res.stats[j.name] for j in jobs})}


def saturn_session(hw, probes):
    """SaturnSession: ``profile()`` with its defaults (the analytic mode:
    a traced step on meta tensors, no trial) for two jobs, then an
    empirical exhaustive profile (real trials on the card), which plans a
    run on this machine's cards with introspection replans."""
    import torch
    from repro_torch.core import ClusterSpec, SaturnSession
    est = probes["ddp"].step_time_s
    sess = SaturnSession(ClusterSpec(nodes=1,
                                     gpus_per_node=torch.cuda.device_count(),
                                     restart_cost_s=1.0), hardware=hw)
    jobs = sess.submit([saturn_job(f"s{i}", steps_for(est, 4.0, 2), lr, i)
                        for i, lr in enumerate([1e-3, 3e-4])])
    t0 = time.perf_counter()
    analytic = sess.profile()
    analytic_s = time.perf_counter() - t0
    by_name = {j.name: j for j in jobs}
    anchors = {k: analytic[k] for k in analytic
               if analytic[k].source == "analytic"}
    if not anchors or not all(from_analysis(sess.runner, by_name[p.job], p)
                              for p in anchors.values()):
        raise AssertionError(f"saturn_session: analytic profiles not from "
                             f"an analysis: {anchors}")
    t0 = time.perf_counter()
    profiles = sess.profile(mode="empirical", strategy="exhaustive")
    profile_s = time.perf_counter() - t0
    d = saturn_dir("session")
    t0 = time.perf_counter()
    res = sess.run(backend="local", introspect_every_s=2.0 * est,
                   ckpt_dir=str(d))
    wall = time.perf_counter() - t0
    saturn_cleanup(d)
    for j in jobs:
        st = res.stats[j.name]
        if sum(s["steps"] for s in st["segments"]) != j.total_steps or \
                not all(math.isfinite(v) for _, v in st["losses"]):
            raise AssertionError(f"saturn_session: {j.name} {st}")
    solver = res.stats.get("solver", [])
    return {"jobs": {j.name: {"steps": j.total_steps, "lr": j.lr}
                     for j in jobs},
            "analytic": {"/".join(map(str, k)): {
                "ms_per_step": p.step_time_s * 1e3,
                "mem_gb": p.mem_per_device / 1e9}
                for k, p in anchors.items()},
            "analytic_s": analytic_s,
            "profiles": {"/".join(map(str, k)): {
                "ms_per_step": p.step_time_s * 1e3, "feasible": p.feasible,
                "source": p.source} for k, p in profiles.items()},
            "trials": sess.runner.trials, "profile_s": profile_s,
            "makespan_s": res.makespan_s, "wall_s": wall,
            "replans": res.replans, "restarts": res.restarts,
            "replan_wall_s": [(r["t"], r["wall_s"], r["status"])
                              for r in solver],
            "loss": {j.name: [res.stats[j.name]["losses"][0][1],
                              res.stats[j.name]["losses"][-1][1]]
                     for j in jobs},
            **segments_of({j.name: res.stats[j.name] for j in jobs})}


def solver_workload(n_jobs, total_gpus, seed=0):
    """benchmarks/run.py's _solver_workload: synthetic jobs with varied
    scaling efficiency on a geometric count grid."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import Job
    from repro_torch.core.profiler import Profile
    cfg = get_config("xlstm-125m").reduced()
    rng = np.random.RandomState(seed)
    counts = [1 << i for i in range(total_gpus.bit_length())]
    jobs, profiles = [], {}
    for i in range(n_jobs):
        j = Job(f"j{i}", cfg, 8, 64, total_steps=int(rng.randint(150, 500)))
        jobs.append(j)
        base = rng.uniform(1.0, 4.0)
        eff = rng.uniform(0.5, 0.95)
        for g in counts:
            for tech, mult in (("ddp", 1.0), ("fsdp", 1.1), ("gpipe", 1.25)):
                profiles[(j.name, tech, g)] = Profile(
                    j.name, tech, g, base * mult / g ** eff, 1e9, True, "t")
    return jobs, profiles


def portfolio_races(steps_of):
    """The portfolio's MILP-vs-LNS races (the MILP leg in a forked child)
    on bench_solver-sized workloads: 8 and 32 jobs on 64 GPUs, seed 0,
    2 s each.  ``steps_of()`` reads a training worker's step
    count; returns the races, their wall seconds and the worker's steps
    during them."""
    from repro_torch.core.lns import validate_capacity
    from repro_torch.core.portfolio import join_stragglers, solve_portfolio
    from repro_torch.core.solver import pooled_choice_map
    races = []
    steps_start, t_races = steps_of(), time.perf_counter()
    for n_jobs in (8, 32):
        jobs, profiles = solver_workload(n_jobs, total_gpus=64)
        cm = pooled_choice_map(jobs, profiles)
        for seed in (0,):
            steps0, t0 = steps_of(), time.perf_counter()
            sol = solve_portfolio(jobs, cm, {None: 64}, wall_budget_s=2.0,
                                  seed=seed)
            wall = time.perf_counter() - t0
            join_stragglers()
            if {a.job for a in sol.assignments} != {j.name for j in jobs} \
                    or not validate_capacity(sol.assignments, {None: 64}):
                raise AssertionError(f"portfolio race: infeasible "
                                     f"{sol.telemetry}")
            tel = sol.telemetry
            races.append({
                "n_jobs": n_jobs, "seed": seed, "winner": tel["backend"],
                "status": tel["status"], "gap": tel["gap"],
                "wall_s": wall, "makespan_s": sol.makespan_s,
                "engines": {k: {"status": e.get("status"),
                                "wall_s": e.get("wall_s")}
                            for k, e in tel["engines"].items()},
                "worker_steps_during": steps_of() - steps0})
    return races, time.perf_counter() - t_races, steps_of() - steps_start


def saturn_portfolio_fork():
    """The portfolio's races while a worker thread trains on the card."""
    from repro_torch.core import ClusterSpec, LocalTorchBackend
    from repro_torch.core.schedule import Placement, ScheduleEntry
    d = saturn_dir("portfolio")
    job = saturn_job("w", 10 ** 6)
    be = LocalTorchBackend(library=saturn_lib(), ckpt_dir=str(d))
    be.bind([job], {}, ClusterSpec(nodes=1, gpus_per_node=1))
    h = be.launch(job, ScheduleEntry("w", "ddp", 1), Placement((0,)),
                  "default", job.total_steps, 0.0, 0)
    w = h.worker
    try:
        while w.steps_done < 2 and not w.done.is_set():
            w.done.wait(0.05)
        alone_step_s = w.measured_step_s
        races, races_s, race_steps = portfolio_races(lambda: w.steps_done)
        if w.error is not None or w.done.is_set():
            raise AssertionError(f"saturn_portfolio_fork: worker stopped "
                                 f"({w.error!r})")
    finally:
        be.preempt(h, be.now())
        saturn_cleanup(d)
    return {"races": races,
            "milp_wins": sum(r["winner"] == "milp" for r in races),
            "worker_step_s_alone": alone_step_s,
            "races_wall_s": races_s, "worker_steps_during_races": race_steps,
            "worker_steps": w.steps_done,
            "worker_step_s": w.measured_step_s}


# ------------------------------------------- supervised worker processes

def launch_log(stats, names):
    """Each launch's supervision timings: seconds from spawn to hello,
    the warm-up step, the mean step after it, the last checkpoint's
    commit and the largest gap between heartbeats."""
    return {n: [{k: seg[k] for k in (
        "technique", "start_step", "steps", "failed", "hello_s",
        "compile_s", "measured_step_s", "commit_s", "max_hb_gap_s")}
        for seg in stats[n]["segments"]] for n in names}


def trajectory(res, name):
    """Absolute step -> loss, last write wins: steps replayed after a
    salvage overwrite their pre-crash records."""
    return dict(res.stats[name]["losses"])


def proc_session(probes, straight):
    """SaturnSession.run(backend="process"): two full-width jobs, each
    segment in its own supervised child on the card, from napkin
    profiles; each job's losses held to a straight BuiltJob run."""
    from repro_torch.checkpoint.store import verify_checkpoint
    from repro_torch.core import ClusterSpec, SaturnSession
    sess = SaturnSession(ClusterSpec(nodes=1, gpus_per_node=1),
                         library=saturn_lib(), device="cuda")
    jobs = sess.submit([saturn_job(f"p{i}", PROC_STEPS, lr, i)
                        for i, lr in enumerate(PROC_LRS)])
    sess.profile(mode="napkin", strategy="exhaustive")
    d = saturn_dir("proc_session")
    t0 = time.perf_counter()
    res = sess.run(backend="process", ckpt_dir=str(d))
    wall = time.perf_counter() - t0
    try:
        durable = {j.name: verify_checkpoint(str(d / f"{j.name}.npz"))["step"]
                   for j in jobs}
    finally:
        saturn_cleanup(d)
    out = {}
    for j in jobs:
        segs = res.stats[j.name]["segments"]
        got = trajectory(res, j.name)
        if res.worker_failures or res.quarantined or \
                sum(s["steps"] for s in segs) != j.total_steps or \
                sorted(got) != list(range(1, j.total_steps + 1)) or \
                durable[j.name] != j.total_steps:
            raise AssertionError(f"proc_session: {j.name} {segs} "
                                 f"{durable} {res.quarantined}")
        ref = straight(j, segs)
        err = max(abs(got[s + 1] - v) for s, v in enumerate(ref))
        if err != 0.0:
            raise AssertionError(f"proc_session: {j.name} losses "
                                 f"{got} against straight {ref}")
        out[j.name] = {"losses": [got[s] for s in sorted(got)],
                       "max_abs_loss_err": err}
    return {"jobs": out, "makespan_s": res.makespan_s, "wall_s": wall,
            "replans": res.replans, "restarts": res.restarts,
            "trial_step_s": {t: p.step_time_s for t, p in probes.items()},
            "launches": launch_log(res.stats, [j.name for j in jobs])}


def recover_run(jobs, name, chaos=None, ckpt_every_steps=10, **backend_kw):
    """One bench_recover run: CurrentPractice on one card, each segment
    in a supervised child; returns the result and its wall seconds."""
    from repro_torch.core import ClusterSpec, ProcessTorchBackend
    from repro_torch.core.baselines import CurrentPractice
    from repro_torch.core.executor import simulate
    from repro_torch.core.profiler import Profile
    profiles = {(j.name, "ddp", 1): Profile(j.name, "ddp", 1, 0.01, 1e9,
                                            True, "t") for j in jobs}
    d = saturn_dir(f"recover_{name}")
    be = ProcessTorchBackend(library=saturn_lib(), ckpt_dir=str(d),
                             ckpt_every_steps=ckpt_every_steps, **backend_kw)
    t0 = time.perf_counter()
    try:
        res = simulate(jobs, CurrentPractice(), profiles,
                       ClusterSpec(nodes=1, gpus_per_node=1,
                                   restart_cost_s=0.5),
                       exec_backend=be, chaos=chaos)
    finally:
        be.shutdown()
        saturn_cleanup(d)
    return res, time.perf_counter() - t0


def recover_jobs():
    """bench_recover's job (xlstm-micro, benchmarks/run.py:818-820) and
    proc_session's first full-width job."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import Job
    cfg = dataclasses.replace(
        get_config("xlstm-125m").reduced(), d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, name="xlstm-micro")
    return [Job("j0", cfg, 2, 32, total_steps=RECOVER_STEPS, lr=1e-3,
                seed=0)], saturn_job("p0", PROC_STEPS)


def recover_runs():
    """bench_recover's scenarios on the card (benchmarks/run.py:791-917):
    xlstm-micro, a checkpoint every 10 steps, each fault deferred to the
    second durable commit (step 20): the baseline, sigkill, hang,
    corrupt and a zero retry budget; beside them one sigkill at full
    width.  The six runs go at once, each with its own backend and
    children (a spawn costs seconds, and the bench's runs in turn would
    not fit the time limit), so every run shares the host and the card
    with the others."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.chaos import ChaosTrace, RetryPolicy, WorkerFault
    jobs, job = recover_jobs()

    def fault(kind, name="j0", min_step=RECOVER_MIN_STEP):
        return ChaosTrace((WorkerFault(RECOVER_FAULT_T, kind, name,
                                       min_step=min_step),))

    runs = {"base": (jobs, None, {}),
            "sigkill": (jobs, fault("sigkill"), {}),
            "hang": (jobs, fault("hang"), {}),
            "corrupt": (jobs, fault("corrupt"), {}),
            "quarantine": (jobs, fault("sigkill"),
                           {"retry_policy": RetryPolicy(budget=0)}),
            # full width: the 1.48 GB chain under supervision, killed at
            # the first durable commit (step 2) and resumed from it
            "full": ([job], fault("sigkill", "p0", 2),
                     {"ckpt_every_steps": 2})}
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {k: pool.submit(recover_run, js, k, chaos, **kw)
                   for k, (js, chaos, kw) in runs.items()}
        return {k: f.result() for k, f in futures.items()}


def proc_recover(out, straight):
    """Holds ``recover_runs``' results to bench_recover's gates: sigkill,
    hang and corrupt land the uninterrupted trajectory exactly, the zero
    budget quarantines; the full-width run equals a straight BuiltJob
    run (``straight``, as in ``proc_session``)."""
    jobs, job = recover_jobs()
    base, wall_base = out["base"]
    t_base = trajectory(base, "j0")
    if base.worker_failures or base.quarantined or \
            sorted(t_base) != list(range(1, RECOVER_STEPS + 1)):
        raise AssertionError(f"proc_recover: baseline {base.stats['j0']}")
    scenarios = {}
    for kind in ("sigkill", "hang", "corrupt"):
        res, wall = out[kind]
        t_f = trajectory(res, "j0")
        segs = res.stats["j0"]["segments"]
        err = max(abs(t_base[s] - t_f[s]) for s in t_base) \
            if set(t_f) == set(t_base) else float("inf")
        scenarios[kind] = {
            "worker_failures": res.worker_failures,
            "restarts": res.restarts, "segments": len(segs),
            "resumed_step": segs[-1]["start_step"],
            "makespan_s": res.makespan_s, "wall_s": wall,
            "overhead_x": res.makespan_s / base.makespan_s,
            "traj_max_err": err, "failed": segs[0]["failed"],
            "launches": launch_log(res.stats, ["j0"])["j0"]}
        if res.worker_failures < 1 or res.restarts < 1 or res.quarantined \
                or err != 0.0:
            raise AssertionError(f"proc_recover: {kind} {scenarios[kind]}")
    resq, wallq = out["quarantine"]
    reason = resq.quarantined.get("j0", "")
    if "retry budget exhausted" not in reason:
        raise AssertionError(f"proc_recover: quarantine {resq.quarantined}")

    full, wall_full = out["full"]
    segs = full.stats["p0"]["segments"]
    got = trajectory(full, "p0")
    if full.worker_failures < 1 or full.restarts < 1 or full.quarantined \
            or segs[-1]["start_step"] != 2 \
            or sorted(got) != list(range(1, PROC_STEPS + 1)):
        raise AssertionError(f"proc_recover: full width {segs}")
    ref = straight(job, [{"technique": "ddp", "steps": PROC_STEPS}])
    full_err = max(abs(got[s + 1] - v) for s, v in enumerate(ref))
    if full_err != 0.0:
        raise AssertionError(f"proc_recover: full width losses {got} "
                             f"against straight {ref}")
    return {"config": jobs[0].cfg.name, "steps": RECOVER_STEPS,
            "concurrent_runs": len(out),
            "fault_t_s": RECOVER_FAULT_T, "fault_min_step": RECOVER_MIN_STEP,
            "baseline_makespan_s": base.makespan_s,
            "baseline_wall_s": wall_base,
            "baseline_launches": launch_log(base.stats, ["j0"])["j0"],
            "scenarios": scenarios,
            "recover_traj_err": max(v["traj_max_err"]
                                    for v in scenarios.values()),
            "recover_overhead_x": max(v["overhead_x"]
                                      for v in scenarios.values()),
            "overhead_gate_x": RECOVER_OVERHEAD_GATE, "overhead_gated": False,
            "recover_completes": 1.0,
            "quarantine": {"reason": reason, "wall_s": wallq,
                           "worker_failures": resq.worker_failures},
            "full_width": {
                "config": job.cfg.name, "batch": job.batch_size,
                "seq": job.seq_len, "steps": PROC_STEPS,
                "ckpt_every_steps": 2, "min_step": 2,
                "worker_failures": full.worker_failures,
                "restarts": full.restarts, "makespan_s": full.makespan_s,
                "wall_s": wall_full, "losses": [got[s] for s in sorted(got)],
                "straight_losses": ref, "max_abs_loss_err": full_err,
                "launches": launch_log(full.stats, ["p0"])["p0"]}}


def proc_portfolio():
    """The races of saturn_portfolio_fork while the full-width worker
    trains in a ProcessTorchBackend child instead of a thread (C4)."""
    from repro_torch.core import ClusterSpec, ProcessTorchBackend
    from repro_torch.core.schedule import Placement, ScheduleEntry
    d = saturn_dir("proc_portfolio")
    job = saturn_job("w", 10 ** 6)
    be = ProcessTorchBackend(library=saturn_lib(), ckpt_dir=str(d))
    be.bind([job], {}, ClusterSpec(nodes=1, gpus_per_node=1))
    h = be.launch(job, ScheduleEntry("w", "ddp", 1), Placement((0,)),
                  "default", job.total_steps, 0.0, 0)
    p = h.worker
    try:
        while p.measured_step_s is None and not p.done.is_set():
            p.done.wait(0.05)     # two steps seen after the warm-up
        alone_step_s = p.measured_step_s
        races, races_s, race_steps = portfolio_races(lambda: p.hb_steps)
        if p.done.is_set():
            raise AssertionError(f"proc_portfolio: worker stopped "
                                 f"({p.error_reason or p.fail_hint})")
    finally:
        be.shutdown()       # kills the child: no final checkpoint to wait on
        saturn_cleanup(d)
    if race_steps < 1:
        raise AssertionError(f"proc_portfolio: no step in {races_s} s of "
                             f"races ({races})")
    return {"races": races,
            "milp_wins": sum(r["winner"] == "milp" for r in races),
            "worker_step_s_alone": alone_step_s,
            "races_wall_s": races_s, "worker_steps_during_races": race_steps,
            "races_wall_over_alone_step": races_s / alone_step_s,
            "worker_steps": p.raw_steps, "worker_step_s": p.measured_step_s,
            "hello_s": p.hello_s, "max_hb_gap_s": p.max_hb_gap_s}


def proc_phases(smi, probes):
    """The process backend's phases; the four kernel counters of this
    process stay at 0 (the children train on the plain paths).  A job's
    straight run is made once for the segments it is held to."""
    from concurrent.futures import ThreadPoolExecutor
    runs = {}

    def straight(job, segs):
        key = (job, tuple((s["technique"], s["steps"]) for s in segs))
        if key not in runs:
            runs[key] = straight_losses(job, segs)
        return runs[key]

    # the recover runs' children train while this process makes the
    # straight runs proc_session's jobs are likely held to (one ddp
    # segment each); a session that segments differently makes its own
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(recover_runs)
        for i, lr in enumerate(PROC_LRS):
            straight(saturn_job(f"p{i}", PROC_STEPS, lr, i),
                     [{"technique": "ddp", "steps": PROC_STEPS}])
        recovered = pending.result()
    emit("proc_recover", nvidia_smi=smi, **proc_recover(recovered, straight),
         kernel_launches=check_no_launches("proc_recover"))
    emit("proc_session", nvidia_smi=smi, **proc_session(probes, straight),
         kernel_launches=check_no_launches("proc_session"))
    emit("proc_portfolio", nvidia_smi=smi, **proc_portfolio(),
         kernel_launches=check_no_launches("proc_portfolio"))


def saturn_phases(smi):
    """Saturn's loop on full-width xlstm-125m jobs; the four kernel
    counters stay at 0."""
    from repro_torch.core import hardware_from_device
    for f in kernel_wrappers().values():
        f.launches = 0
    hw = hardware_from_device("cuda")
    info, probes, runner = saturn_profile(hw)
    emit("saturn_profile", nvidia_smi=smi, **info,
         kernel_launches=check_no_launches("saturn_profile"))
    emit("saturn_roofline_loops", nvidia_smi=smi, **roofline_loops(),
         kernel_launches=check_no_launches("saturn_roofline_loops"))
    emit("saturn_roofline", nvidia_smi=smi,
         **saturn_roofline(runner, probes),
         kernel_launches=check_no_launches("saturn_roofline"))
    del runner
    emit("saturn_fidelity", nvidia_smi=smi, **saturn_fidelity(probes),
         kernel_launches=check_no_launches("saturn_fidelity"))
    emit("saturn_restart", nvidia_smi=smi, **saturn_restart(probes),
         kernel_launches=check_no_launches("saturn_restart"))
    emit("saturn_session", nvidia_smi=smi, **saturn_session(hw, probes),
         kernel_launches=check_no_launches("saturn_session"))
    emit("saturn_portfolio_fork", nvidia_smi=smi, **saturn_portfolio_fork(),
         kernel_launches=check_no_launches("saturn_portfolio_fork"))
    proc_phases(smi, probes)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import concrete_batch, get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import (init_model, model_spec,
                                                prefill_forward)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    smi = smi_line()
    card = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    # ---------------------------------------------------------- build
    t0 = time.perf_counter()
    info = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if any(w in ln for w in (
                                    "registers", "spill", "wgmma",
                                    "setmaxnreg", "arning"))]}
                  for k, v in info.items()})

    # ----------------------------------------------- the gradient rule
    emit("grad_rule", wrappers=grad_rule())

    # -------------------------------------------------------- kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        # the shapes of tests/test_kernels.py, then two with a ragged
        # last tile (S not a multiple of 64) at the model's head_dim, two
        # at the head dims the kernels pad (120 to 128, 160 to 192), and
        # the persistent kernel's 128-key tiles at D 128 and 64: S not a
        # multiple of 128, windows that cut a tile, internvl2-1b's 7:1 GQA
        # and musicgen-medium's MHA
        for s, h, kv, d, w in [(256, 4, 4, 64, 0), (256, 4, 2, 64, 0),
                               (512, 8, 1, 32, 0), (256, 4, 2, 64, 100),
                               (384, 2, 2, 128, 128), (200, 4, 2, 256, 0),
                               (300, 8, 4, 256, 100), (200, 4, 2, 120, 0),
                               (300, 8, 4, 160, 100), (200, 4, 4, 128, 0),
                               (300, 8, 4, 128, 0), (300, 4, 4, 128, 100),
                               (384, 4, 2, 128, 192), (200, 4, 4, 64, 0),
                               (300, 14, 2, 64, 0), (300, 14, 2, 64, 192),
                               (384, 24, 24, 64, 100)]:
            cases.append(kernel_case(flash_attention, flash_attention_plain,
                                     gen, 2, s, h, kv, d, w, dtype, tol))
    cfg = get_config("gemma3-4b")
    hd = cfg.resolved_head_dim
    main_cases = {}
    for w in (0, cfg.window_size):
        c = kernel_case(flash_attention, flash_attention_plain, gen,
                        PREFILL_B, PREFILL_S, cfg.num_heads, cfg.num_kv_heads,
                        hd, w, torch.bfloat16, 2e-2)
        cases.append(c)
        main_cases[w] = c
    emit("kernels", cases=cases)

    # ------------------------- flash attention at the padded head dims
    # one batch row at the attention shapes of h2o-danube-3-4b (D 120,
    # window 4096, S ragged and past the window) and stablelm-12b (D 160,
    # global), in both dtypes
    head_dim_cases = []
    for arch, s in (("h2o-danube-3-4b", 4500), ("stablelm-12b", 2100)):
        hc = get_config(arch)
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            c = kernel_case(flash_attention, flash_attention_plain, gen, 1, s,
                            hc.num_heads, hc.num_kv_heads,
                            hc.resolved_head_dim, hc.window_size, dtype,
                            tol)
            head_dim_cases.append({"config": arch, **c})
    emit("flash_head_dims", cases=head_dim_cases)

    # ---------------------- flash attention across head dims, bf16
    emit("flash_d_sweep", cases=flash_d_sweep(gen))
    torch.cuda.empty_cache()                     # the plain versions' scores

    # -------------------------------------------------------- small check
    small = cfg.reduced()                        # 6 layers
    emit("check", config=small.name, **small_check(small))

    # -------------------------------------------------------- prefill
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model_spec(cfg))
    if not 3.3e9 <= n_params <= 4.5e9:
        raise AssertionError(f"param_count {n_params}")
    batch = concrete_batch(cfg, PREFILL_B, PREFILL_S, device="cuda")
    prefill_forward(params, cfg, batch)          # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, pstate = prefill_forward(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = flash_attention.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"{launches} flash launches, "
                             f"expected {cfg.num_layers}")
    if logits.shape != (PREFILL_B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite / wrong shape")

    layer_err = []
    prefill_forward(params, cfg, batch, opts={"attn_fn": comparing(
        layer_err, flash_attention, flash_attention_plain)})
    if len(layer_err) != cfg.num_layers or max(layer_err) > 2e-2:
        raise AssertionError(f"per-layer kernel error {layer_err}")
    emit("prefill", config=cfg.name, param_count=n_params,
         batch=PREFILL_B, seq=PREFILL_S, init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_s,
         flash_launches=launches, layer_rel_err=layer_err,
         worst_layer_rel_err=max(layer_err),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # ------------------------------------------------------- generate
    state = seeded_state(cfg, pstate, PREFILL_B, PREFILL_S,
                         PREFILL_S + GEN_TOKENS)
    del pstate
    toks, gen_s = greedy(cfg, params, logits, state, GEN_TOKENS - 1)
    emit("generate", tokens=GEN_TOKENS, batch=PREFILL_B,
         decode_steps=GEN_TOKENS - 1, seconds=gen_s,
         tokens_per_s=PREFILL_B * (GEN_TOKENS - 1) / gen_s,
         first_tokens=toks[0, :8].tolist())
    del state

    # ---------------------------------------------------------- serve
    serve_s, served = serve_requests(cfg, params, seed=1)
    emit("serve", seconds=serve_s, **served)

    # ------------------------------------------------------- summary
    n_global = sum(t == "attn" for t in cfg.layer_types())
    n_window = cfg.num_layers - n_global

    def per_prefill(key):
        return (n_window * main_cases[cfg.window_size][key]
                + n_global * main_cases[0][key])

    bound_ops = sum(
        attention_bound(PREFILL_B, PREFILL_S, cfg.num_heads,
                        cfg.num_kv_heads, hd, w, "bfloat16", 2)[1]
        == "operations" for w in (0, cfg.window_size))
    flash_line = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches,
        "max_abs_err": max(c["max_err"] for c in main_cases.values()),
        "ms": per_prefill("kernel_ms"), "plain_ms": per_prefill("plain_ms"),
        "bound_ms": per_prefill("bound_ms"),
        "bound_by": "operations" if bound_ops == 2 else "bytes",
        "library_ms": per_prefill("library_ms"),
        "per": f"one prefill: {n_window} window-{cfg.window_size} + "
               f"{n_global} global launches at B {PREFILL_B}, S {PREFILL_S}, "
               f"H {cfg.num_heads}, Kv {cfg.num_kv_heads}, D {hd}, bf16"}
    del params, logits
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- xLSTM
    xlstm_lines = xlstm_phases(gen)
    torch.cuda.empty_cache()

    # ------------------------------------------------- recurrentgemma
    rgemma_lines = rgemma_phases(gen)
    torch.cuda.empty_cache()

    # ---------------------------------------------------- olmoe (MoE)
    olmoe_line = olmoe_phases(gen)
    torch.cuda.empty_cache()

    # ------------------------------------------------------- training
    train_phases()

    # ------------------------------------------------- process groups
    par_phases(smi)

    # ------------------------------------------------- Saturn's loop
    saturn_phases(smi)
    print(json.dumps({"kernels": [flash_line] + xlstm_lines
                      + rgemma_lines + [olmoe_line]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:
        sys.exit(resume_child(sys.argv[2]))
    sys.exit(main())
