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
  state, the engine answering 8 requests).

Every phase prints one JSON line and raises on failure.  The line
before the last lists every ported kernel; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA
device or without the repo's ``src/repro_torch`` beside this script.
"""
import json
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


def mlstm_case(kern, plain, gen, b, s, h, d, dtype):
    """The mLSTM kernel against its plain version on the inputs of
    tests/test_kernels.py (standard normal; forget pre-activations
    around +2)."""
    import torch
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
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
            "tol": [tol, 5e-2], "max_err": max_err,
            "kernel_ms": time_ms(lambda: kern(*xs)),
            "launches": kern.launches - n0,
            "plain_ms": time_ms(lambda: plain(*xs), runs=3, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def slstm_case(kern, plain, gen, b, s, h, d, dtype):
    """The sLSTM kernel against its plain version on the inputs of
    tests/test_kernels.py (gates N(0, 0.5^2), R N(0, 0.05^2)).  The plain
    version is a loop over S steps, so it is timed once after the check."""
    import torch
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
    return {"kernel": "slstm_step_scan", "shape": [b, s, h, d],
            "dtype": name, "tol": [atol, rtol], "max_err": max_err,
            "kernel_ms": time_ms(lambda: kern(gates, *rs)),
            "launches": kern.launches - n0,
            "plain_ms": time_ms(lambda: plain(gates, *rs), runs=1, warmup=0),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


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
        # kernel masks its last chunk) at the model's head dim
        for s, h, hd in [(256, 2, 64), (512, 4, 128), (200, nh, dm),
                         (37, 2, 96)]:
            cases.append(mlstm_case(mlstm_chunk, mlstm_chunk_plain, gen,
                                    2, s, h, hd, dtype))
        for s, h, hd in [(256, 2, 128), (128, 4, 64), (256, 1, 256),
                         (300, nh, ds)]:
            cases.append(slstm_case(slstm_step_scan, slstm_step_plain, gen,
                                    2, s, h, hd, dtype))
    main_m = mlstm_case(mlstm_chunk, mlstm_chunk_plain, gen, XLSTM_B,
                        XLSTM_S, nh, dm, torch.bfloat16)
    main_s = slstm_case(slstm_step_scan, slstm_step_plain, gen, XLSTM_B,
                        XLSTM_S, nh, ds, torch.bfloat16)
    cases += [main_m, main_s]
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
    from repro_torch.models.transformer import (init_decode_state, init_model,
                                                model_spec, prefill_forward,
                                                state_batch_axes)

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
                                if "registers" in ln or "spill" in ln]}
                  for k, v in info.items()})

    # -------------------------------------------------------- kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        # the shapes of tests/test_kernels.py, then two with a ragged
        # last tile (S not a multiple of 64) at the model's head_dim
        for s, h, kv, d, w in [(256, 4, 4, 64, 0), (256, 4, 2, 64, 0),
                               (512, 8, 1, 32, 0), (256, 4, 2, 64, 100),
                               (384, 2, 2, 128, 128), (200, 4, 2, 256, 0),
                               (300, 8, 4, 256, 100)]:
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
    state = init_decode_state(cfg, PREFILL_B, PREFILL_S + GEN_TOKENS,
                              dtype=torch.bfloat16, device="cuda")
    axes = state_batch_axes(cfg)["layers"]
    for gi, group in enumerate(pstate["layers"]):
        for key, cache in group.items():
            for leaf, src_t in cache.items():
                seq_ax = axes[gi][key][leaf] + 1
                state["layers"][gi][key][leaf].narrow(
                    seq_ax, 0, PREFILL_S).copy_(src_t)
    state["pos"] = torch.tensor(PREFILL_S, dtype=torch.int32, device="cuda")
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
    print(json.dumps({"kernels": [flash_line] + xlstm_lines}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
