#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, then serves full-width
gemma3-4b (random weights from a seed) in bf16: a batched prefill with
the flash-attention kernel in all 34 layers, greedy decode from the
prefill's caches, and the continuous-batching engine answering 8
requests.  Every phase prints one JSON line and raises on failure.
The line before the last lists every ported kernel; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA
device or without the repo's ``src/repro_torch`` beside this script.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
PREFILL_B, PREFILL_S = 4, 4096
GEN_TOKENS = 32


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


def kernel_case(fa, plain, gen, b, s, h, kv, d, window, dtype, tol):
    import torch
    q = (torch.randn(b, s, h, d, generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
    n0 = fa.launches
    out = fa(q, k, v, window)
    torch.cuda.synchronize()
    ref = plain(q, k, v, window).float()
    diff = (out.float() - ref).abs()
    max_err = float(diff.max())
    if not bool((diff <= tol + tol * ref.abs()).all()):
        raise AssertionError(f"flash_attention {(b, s, h, kv, d, window)} "
                             f"{dtype}: max_err {max_err} beyond {tol}")
    name = str(dtype).replace("torch.", "")
    bound_ms, bound_by = attention_bound(b, s, h, kv, d, window, name,
                                         q.element_size())
    return {"shape": [b, s, h, kv, d], "window": window, "dtype": name,
            "tol": tol, "max_err": max_err,
            "kernel_ms": time_ms(lambda: fa(q, k, v, window)),
            "launches": fa.launches - n0,
            "plain_ms": time_ms(lambda: plain(q, k, v, window)),
            "library_ms": time_ms(lambda: sdpa(q, k, v, window)),
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state, init_model,
                                                model_spec, prefill_forward,
                                                state_batch_axes)
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    from repro_torch.train.steps import make_serve_step

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
    # kernel path against the plain path end to end at a size where
    # random-init models are not chaotic (6 layers, B 2, S 8, fp32)
    small = cfg.reduced()
    sp = init_model(small, seed=1, dtype=torch.float32, device="cuda")
    sb = concrete_batch(small, 2, 8, device="cuda")
    lk, _ = forward(sp, small, sb)
    lp, _ = forward(sp, small, sb, opts={})
    st = init_decode_state(small, 2, 8, dtype=torch.float32, device="cuda")
    for i in range(8):
        ld, st = decode_step(sp, small, sb["tokens"][:, i:i + 1], st)
    small_err = {"kernel_vs_plain": float((lk - lp).abs().max()),
                 "decode_vs_forward": float((ld[:, 0] - lk[:, -1]).abs().max())}
    if small_err["kernel_vs_plain"] > 1e-4 or small_err["decode_vs_forward"] > 5e-4:
        raise AssertionError(f"small-model check failed: {small_err}")
    emit("check", config=small.name, **small_err)

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

    def compare(q, k, v, window):
        out = flash_attention(q, k, v, window)
        ref = flash_attention_plain(q, k, v, window).float()
        layer_err.append(float((out.float() - ref).abs().max()
                               / ref.abs().max()))
        return out

    prefill_forward(params, cfg, batch, opts={"attn_fn": compare})
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
    serve_step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    generated = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GEN_TOKENS - 1):
        tok, step_logits, state = serve_step(params, tok, state)
        generated.append(tok)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    toks = torch.cat(generated, dim=1)
    if int(state["pos"]) != PREFILL_S + GEN_TOKENS - 1 or \
            not bool(torch.isfinite(step_logits).all()) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("greedy decode produced bad state or tokens")
    emit("generate", tokens=GEN_TOKENS, batch=PREFILL_B,
         decode_steps=GEN_TOKENS - 1, seconds=gen_s,
         tokens_per_s=PREFILL_B * (GEN_TOKENS - 1) / gen_s,
         first_tokens=toks[0, :8].tolist())
    del state

    # ---------------------------------------------------------- serve
    rng = torch.Generator().manual_seed(1)
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
    serve_s = time.perf_counter() - t0
    if len(done) != 8 or any(len(r.output) != r.max_new_tokens
                             for r in done):
        raise AssertionError("engine did not finish all 8 requests")
    emit("serve", seconds=serve_s, **eng.throughput())

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
    print(json.dumps({"kernels": [{
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
               f"H {cfg.num_heads}, Kv {cfg.num_kv_heads}, D {hd}, bf16"}]}),
          flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
