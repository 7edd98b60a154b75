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
  engine answering 8 requests.

Flash attention is also held against its plain version at the head dims
the kernels pad (D 120, h2o-danube-3-4b; D 160, stablelm-12b) in both
dtypes, and the sLSTM kernel at the xLSTM shape in fp32 as well.  Before
any of that, each of the four wrappers is shown to refuse a CUDA input
that requires grad while grad mode is on, and to launch under
``torch.no_grad()``.

Then training, in fp32 on the model's plain paths (the kernels have no
backward, and the JAX package trains without them), with the four
kernels' launch counters held at 0 throughout:

- ``train_check``: one train step of xlstm-125m.reduced() on the card
  and on the CPU from the same parameters and batch, held together;
- ``train_step``: xlstm-125m at full width, B 8 x S 512, through
  ``BuiltJob`` at ``ddp`` and at ``remat-offload``, one warm-up and two
  timed steps at ``ddp`` (and the forward alone), one at
  ``remat-offload``, then a warm-up and a timed step with the
  batched-gradient sLSTM scan;
- ``train_resume``: in a child process with deterministic algorithms on,
  four straight steps against two steps, a checkpoint, a resume and two
  more steps, bit-equal;
- ``train_cli``: ``python -m repro_torch.launch.train`` at full width
  for two steps, leaving a checkpoint that verifies.

Then Saturn's own loop (profile -> solve -> execute -> observe ->
replan) on xlstm-125m jobs at full width, B 8 x S 128, fp32, with the
kernel counters still held at 0 (checkpoints under ``build/saturn/``,
removed after each phase):

- ``saturn_profile``: the empirical Trial Runner, one warm-up and two
  timed steps at ``ddp`` x1 and ``remat-offload`` x1, against the
  card's own ``HardwareSpec``;
- ``saturn_fidelity``: three jobs under one SaturnStatic schedule,
  predicted by the SimBackend and executed by ``LocalTorchBackend``;
- ``saturn_restart``: an introspection replan flips j0 from ``ddp`` x1
  to ``remat-offload`` x1 mid-run (checkpoint, restart, resume), and j0
  is rerun straight through ``BuiltJob`` to hold its losses;
- ``saturn_session``: ``SaturnSession`` profiles two jobs empirically
  and trains them through ``run(backend="local")``;
- ``saturn_portfolio_fork``: the solver portfolio's MILP-vs-LNS races,
  each forking a child for the MILP leg, while a worker trains.

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
# timed steps, after one warm-up step (each step is host-bound, 6-20 s)
TRAIN_STEPS = {"ddp": 2, "remat-offload": 1}
CLI_STEPS = 2                # launch.train's steps in train_cli
CHECK_B, CHECK_S = 4, 64     # train_check and train_resume, reduced config
SATURN_B, SATURN_S = 8, 128  # the Saturn jobs' batch and sequence
# saturn_restart: the segmented run's losses against a straight run of the
# same steps on the same card, relative
SATURN_LOSS_RTOL = 1e-6
# train_check, CUDA against CPU at fp32: loss and grad_norm relative; the
# parameters after one step at lr 1e-3 absolute (the CPU tests hold the
# port to the JAX package at 1e-4 on xlstm-micro)
TRAIN_CHECK_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4}


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


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


def train_check():
    """One fp32 train step of xlstm-125m.reduced() on the card and on the
    CPU from the same parameters and SyntheticLM batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = get_config("xlstm-125m").reduced()
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=100))
    batch = next(SyntheticLM(cfg, seed=0).batches(CHECK_B, CHECK_S,
                                                  device="cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev),
                          init_model(cfg, seed=3, device="cpu"))
        out[dev] = step(params, init_opt_state(params),
                        {k: v.to(dev) for k, v in batch.items()})
    (pc, oc, mc), (pg, og, mg) = out["cpu"], out["cuda"]
    rel = lambda k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
    param_err, leaf = max_leaf_diff(pg, pc)
    err = {"loss": rel("loss"), "grad_norm": rel("grad_norm"),
           "params": param_err}
    if any(err[k] > TRAIN_CHECK_TOL[k] for k in err) or \
            int(og["step"]) != 1:
        raise AssertionError(f"train_check: CUDA step against CPU step {err} "
                             f"(worst leaf {leaf}), bound {TRAIN_CHECK_TOL}")
    return {"config": cfg.name, "batch": CHECK_B, "seq": CHECK_S,
            "err": err, "worst_param_leaf": leaf, "tol": TRAIN_CHECK_TOL,
            "err_means": "loss, grad_norm: |cuda - cpu| / |cpu|; params: "
                         "max |cuda - cpu| after the step",
            "loss": {"cuda": float(mg["loss"]), "cpu": float(mc["loss"])}}


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
    """xlstm-125m at full width, fp32, B 8 x S 512 through BuiltJob at ddp
    and remat-offload (one device each), then two steps with the
    batched-gradient sLSTM scan."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.train.steps import lm_loss, make_train_step
    cfg = get_config("xlstm-125m")
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
        s_step = statistics.median(secs[1:])
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
                     "tokens_per_s": TRAIN_B * TRAIN_S / s_step,
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
    ``CLI_STEPS`` steps; its checkpoint must verify."""
    import os
    from repro_torch.checkpoint.store import verify_checkpoint
    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "train_cli" / "ck.npz"
    for stale in ckpt.parent.glob("ck.npz*"):
        stale.unlink()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "xlstm-125m", "--technique", "ddp", "--devices", "1", "--steps",
           str(CLI_STEPS), "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
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
    emit("train_step", **train_step_phase(),
         kernel_launches=check_no_launches("train_step"))
    emit("train_resume", **train_resume())
    emit("train_cli", **train_cli())
    check_no_launches("training")


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
    from repro_torch.configs import get_config
    from repro_torch.core import Job
    return Job(name, get_config("xlstm-125m"), SATURN_B, SATURN_S,
               total_steps=steps, lr=lr, seed=seed)


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
                      for t, p in probes.items()}}, probes


def saturn_fidelity(probes):
    """bench_e2e scenario 1 at one device: one SaturnStatic plan of three
    jobs, predicted by the SimBackend and executed for real."""
    from repro_torch.core import ClusterSpec, LocalTorchBackend
    from repro_torch.core.baselines import SaturnStatic
    from repro_torch.core.executor import simulate
    est = probes["ddp"].step_time_s
    cluster = ClusterSpec(nodes=1, gpus_per_node=1, restart_cost_s=1.0)
    jobs = [saturn_job(f"j{i}", steps_for(est, s, 2), lr, i)
            for i, (s, lr) in enumerate([(6.0, 1e-3), (4.0, 3e-4),
                                         (4.0, 1e-3)])]
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
    jobs = [saturn_job("j0", long_steps)] + \
        [saturn_job(f"j{i}", 2, seed=i) for i in (1, 2)]
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
    """SaturnSession: empirical profiles of two jobs, then a run on this
    machine's cards with introspection replans."""
    import torch
    from repro_torch.core import ClusterSpec, SaturnSession
    est = probes["ddp"].step_time_s
    sess = SaturnSession(ClusterSpec(nodes=1,
                                     gpus_per_node=torch.cuda.device_count(),
                                     restart_cost_s=1.0), hardware=hw)
    jobs = sess.submit([saturn_job(f"s{i}", steps_for(est, 4.0, 2), lr, i)
                        for i, lr in enumerate([1e-3, 3e-4])])
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
            "profiles": {"/".join(map(str, k)): {
                "ms_per_step": p.step_time_s * 1e3, "feasible": p.feasible}
                for k, p in profiles.items()},
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


def saturn_portfolio_fork():
    """The portfolio's MILP-vs-LNS race (the MILP leg in a forked child)
    on bench_solver-sized workloads while a worker trains on the card."""
    from repro_torch.core import ClusterSpec, LocalTorchBackend
    from repro_torch.core.lns import validate_capacity
    from repro_torch.core.portfolio import join_stragglers, solve_portfolio
    from repro_torch.core.schedule import Placement, ScheduleEntry
    from repro_torch.core.solver import pooled_choice_map
    d = saturn_dir("portfolio")
    job = saturn_job("w", 10 ** 6)
    be = LocalTorchBackend(library=saturn_lib(), ckpt_dir=str(d))
    be.bind([job], {}, ClusterSpec(nodes=1, gpus_per_node=1))
    h = be.launch(job, ScheduleEntry("w", "ddp", 1), Placement((0,)),
                  "default", job.total_steps, 0.0, 0)
    w = h.worker
    races = []
    try:
        while w.steps_done < 2 and not w.done.is_set():
            w.done.wait(0.05)
        alone_step_s = w.measured_step_s
        steps0, t_races = w.steps_done, time.perf_counter()
        for n_jobs in (8, 32):
            jobs, profiles = solver_workload(n_jobs, total_gpus=64)
            cm = pooled_choice_map(jobs, profiles)
            for seed in (0, 1):
                steps0, t0 = w.steps_done, time.perf_counter()
                sol = solve_portfolio(jobs, cm, {None: 64},
                                      wall_budget_s=2.0, seed=seed)
                wall = time.perf_counter() - t0
                join_stragglers()
                if {a.job for a in sol.assignments} != \
                        {j.name for j in jobs} or \
                        not validate_capacity(sol.assignments, {None: 64}):
                    raise AssertionError(f"saturn_portfolio_fork: "
                                         f"infeasible {sol.telemetry}")
                tel = sol.telemetry
                races.append({
                    "n_jobs": n_jobs, "seed": seed, "winner": tel["backend"],
                    "status": tel["status"], "gap": tel["gap"],
                    "wall_s": wall, "makespan_s": sol.makespan_s,
                    "engines": {k: {"status": e.get("status"),
                                    "wall_s": e.get("wall_s")}
                                for k, e in tel["engines"].items()},
                    "worker_steps_during": w.steps_done - steps0})
        races_s = time.perf_counter() - t_races
        race_steps = w.steps_done - steps0
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


def saturn_phases(smi):
    """Saturn's loop on full-width xlstm-125m jobs; the four kernel
    counters stay at 0."""
    from repro_torch.core import hardware_from_device
    for f in kernel_wrappers().values():
        f.launches = 0
    hw = hardware_from_device("cuda")
    info, probes = saturn_profile(hw)
    emit("saturn_profile", nvidia_smi=smi, **info,
         kernel_launches=check_no_launches("saturn_profile"))
    emit("saturn_fidelity", nvidia_smi=smi, **saturn_fidelity(probes),
         kernel_launches=check_no_launches("saturn_fidelity"))
    emit("saturn_restart", nvidia_smi=smi, **saturn_restart(probes),
         kernel_launches=check_no_launches("saturn_restart"))
    emit("saturn_session", nvidia_smi=smi, **saturn_session(hw, probes),
         kernel_launches=check_no_launches("saturn_session"))
    emit("saturn_portfolio_fork", nvidia_smi=smi, **saturn_portfolio_fork(),
         kernel_launches=check_no_launches("saturn_portfolio_fork"))


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
        # last tile (S not a multiple of 64) at the model's head_dim, and
        # two at the head dims the kernels pad (120 to 128, 160 to 192)
        for s, h, kv, d, w in [(256, 4, 4, 64, 0), (256, 4, 2, 64, 0),
                               (512, 8, 1, 32, 0), (256, 4, 2, 64, 100),
                               (384, 2, 2, 128, 128), (200, 4, 2, 256, 0),
                               (300, 8, 4, 256, 100), (200, 4, 2, 120, 0),
                               (300, 8, 4, 160, 100)]:
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

    # ------------------------------------------------------- training
    train_phases()

    # ------------------------------------------------- Saturn's loop
    saturn_phases(smi)
    print(json.dumps({"kernels": [flash_line] + xlstm_lines
                      + rgemma_lines}), flush=True)
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
