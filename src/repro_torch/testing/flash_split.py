"""Time the bf16 flash-attention kernel: a head-dim sweep, a split of its
time into parts, and an alternated comparison with another source.

    PYTHONPATH=src python -m repro_torch.testing.flash_split \\
        [--sweep] [--split D [D ...]] [--old] [--compare OTHER.cu] \\
        [--rounds 3] [--runs 10]

Every part builds its libraries from ``csrc/flash_attention.cu`` (or
``OTHER.cu``) with ``nvcc`` into ``build/flash_split/``, apart from the
wrapper's own library, and prints one JSON line a record:

- ``--sweep``: the kernel and one ``scaled_dot_product_attention`` call
  (the yardstick) at B 4, S 4096, window 0, with H * D = 2048 and
  Kv = H at D 64, 128 and 256, so every shape has the same FLOPs.
- ``--split D [D ...]``: the kernel at B 4, S 4096, window 0 with head
  dim D (H * D = 2048, Kv = H), built once as it is and once for each
  variant in ``VARIANTS``, each switching a part off or changing it with
  ``FLASH_SPLIT_*`` macros.  A variant's output is garbage; only its time
  counts.  The wrapper never sets these macros.  ``--old`` builds every
  variant with the kernel of D > 128 at every D (FLASH_SPLIT_OLD), the
  design D <= 128 had before the persistent kernel.
- ``--compare OTHER.cu``: OTHER's kernel against this tree's at the
  prefill shapes of the kernel table, timed in turns (other, this, this,
  other) for ``--rounds`` rounds in one process on one card.

Times are medians of ``--runs`` CUDA-event timings of one launch.  The
first line names the card and its power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..configs import get_config
from ..kernels import _build
from ..kernels.flash_attention import flash_attention_plain, workspace

OUT_DIR = _build.BUILD_DIR.parent / "flash_split"
SOURCE = _build.CSRC / _build.SOURCES["flash_attention"]
B, S = 4, 4096
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s

# name: the macros of a variant (see the kernel's source).  At D <= 128
# the persistent kernel takes them all; the kernel of D > 128 (every D
# under --old) ignores NO_LOADS, NO_STORE, NO_PINGPONG and PV_N64, and
# its default order is ORDER=0 where the persistent kernel's is ORDER=2.
VARIANTS = {
    "base": (),
    "no_ex2": ("FLASH_SPLIT_NO_EX2",),            # ex2 becomes a multiply
    "no_softmax": ("FLASH_SPLIT_NO_SOFTMAX",),    # scores packed as P
    "no_qk": ("FLASH_SPLIT_NO_QK",),              # no Q K^T products
    "no_pv": ("FLASH_SPLIT_NO_PV",),              # no P V products
    "no_mma": ("FLASH_SPLIT_NO_QK", "FLASH_SPLIT_NO_PV"),
    "no_loads": ("FLASH_SPLIT_NO_LOADS",),        # no TMA: products, softmax
    "mma_only": ("FLASH_SPLIT_NO_LOADS", "FLASH_SPLIT_NO_SOFTMAX"),
    "softmax_only": ("FLASH_SPLIT_NO_LOADS", "FLASH_SPLIT_NO_QK",
                     "FLASH_SPLIT_NO_PV"),
    "loads_only": ("FLASH_SPLIT_LOADS_ONLY",),    # wait for K and V, release
    "no_store": ("FLASH_SPLIT_NO_STORE",),        # O never written
    "one_tile": ("FLASH_SPLIT_ONE_TILE",),        # each query tile: 1 KV tile
    "stages_2": ("FLASH_SPLIT_STAGES=2",),        # the ring's depth
    "stages_6": ("FLASH_SPLIT_STAGES=6",),
    "order_interleaved": ("FLASH_SPLIT_ORDER=0",),  # heads inner, whole grid
    "order_head": ("FLASH_SPLIT_ORDER=1",),       # a head's tiles in a row
    "order_l2": ("FLASH_SPLIT_ORDER=2",),         # heads in L2-sized sections
    "loads_only_order_l2": ("FLASH_SPLIT_LOADS_ONLY", "FLASH_SPLIT_ORDER=2"),
    "no_pingpong": ("FLASH_SPLIT_NO_PINGPONG",),  # warpgroups unordered
    "pv_n64": ("FLASH_SPLIT_PV_N64",),            # P V as n64 products
}

# the kernel table's prefill rows: (config, window or None for the
# config's own)
TABLE_ROWS = (("gemma3-4b", 0), ("gemma3-4b", None),
              ("recurrentgemma-2b", None), ("olmoe-1b-7b", 0),
              ("internvl2-1b", 0), ("musicgen-medium", 0))


def build(source: Path, variants: dict) -> dict:
    """{name: (ctypes function, ptxas lines)}; one nvcc a variant, all
    started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = source.read_bytes()
    procs = {}
    for name, macros in variants.items():
        digest = hashlib.sha256(text + repr(macros).encode()).hexdigest()[:12]
        path = OUT_DIR / f"libflash-{name}-{digest}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *(f"-D{m}" for m in macros), "-o", str(path), str(source)]
        procs[name] = (path, None if path.exists() else subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (path, proc) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        fn = ctypes.CDLL(str(path)).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "flash_fwd_bf16" in ln or "registers" in ln
                 or "spill" in ln]
        out[name] = (fn, ptxas)
    return out


def launcher(fn, q, k, v, window, scratch=True):
    """A no-argument launch of ``fn`` (a library's flash_attention_fwd) as
    the wrapper calls it, with the stream's workspace unless ``scratch``
    is False (a source whose function takes none ignores the argument)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    out = torch.empty_like(q)

    stream = torch.cuda.current_stream()
    ws = workspace(q, stream) if scratch else None

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, h, kv, d, window, 1, stream.cuda_stream,
                 None if ws is None else ws.data_ptr())
        if err:
            raise RuntimeError(f"flash_attention_fwd: cudaError {err}")
        return out
    return run


def time_ms(fn, runs, warmup=2):
    """Median over ``runs`` of one call's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


def live_pairs(s, window):
    if not window:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def bound(b, s, h, kv, d, window):
    """(bound_ms, bound_by) of bf16 attention: 4 D FLOPs a live pair at
    the tensor-core peak; q, k, v read and out written once."""
    t_ops = 4.0 * d * live_pairs(s, window) * b * h / PEAK_BF16 * 1e3
    t_bytes = 2.0 * (2 * b * s * h * d + 2 * b * s * kv * d) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sdpa(q, k, v, window):
    """One PyTorch call computing the same function: the yardstick."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(q.shape[1], device=q.device)[None, :]
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=(j <= i) & ((i - j) < window), scale=1.0,
            enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             scale=1.0, enable_gqa=True)
    return out.transpose(1, 2)


def inputs(gen, b, s, h, kv, d):
    q = (torch.randn(b, s, h, d, generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, k, v


def max_err(out, q, k, v, window):
    return float((out.float() - flash_attention_plain(q, k, v, window)
                  .float()).abs().max())


def sweep(gen, runs):
    libs = build(SOURCE, {"base": ()})
    fn = libs["base"][0]
    for d in (64, 128, 256):
        h = 2048 // d
        q, k, v = inputs(gen, B, S, h, h, d)
        run = launcher(fn, q, k, v, 0)
        bms, by = bound(B, S, h, h, d, 0)
        ms = time_ms(run, runs)
        lib = time_ms(lambda: sdpa(q, k, v, 0), runs)
        yield {"part": "sweep", "shape": [B, S, h, h, d], "window": 0,
               "kernel_ms": ms, "library_ms": lib, "bound_ms": bms,
               "bound_by": by, "bound_share": bms / ms,
               "max_err": max_err(run(), q, k, v, 0)}


def split(gen, d, runs, rounds, old=False):
    variants = {name: macros + ("FLASH_SPLIT_OLD",) * old
                for name, macros in VARIANTS.items()}
    libs = build(SOURCE, variants)
    h = 2048 // d
    q, k, v = inputs(gen, B, S, h, h, d)
    runs_of = {name: launcher(fn, q, k, v, 0)
               for name, (fn, _) in libs.items()}
    times = {name: [] for name in libs}
    for _ in range(rounds):
        for name, run in runs_of.items():
            times[name].append(time_ms(run, runs))
    base = statistics.median(times["base"])
    bms, by = bound(B, S, h, h, d, 0)
    for name, ts in times.items():
        ms = statistics.median(ts)
        yield {"part": "split", "variant": name,
               "macros": list(variants[name]), "shape": [B, S, h, h, d],
               "ms": ms, "rounds_ms": ts, "saved_ms": base - ms,
               "bound_ms": bms, "bound_by": by,
               "ptxas": libs[name][1] if name == "base" else None}


def compare(gen, other: Path, runs, rounds):
    libs = {"other": build(other, {"base": ()})["base"][0],
            "this": build(SOURCE, {"base": ()})["base"][0]}
    # whether the entry point takes a workspace (older sources do not)
    scratch = {"other": b"void* workspace" in other.read_bytes(),
               "this": True}
    for arch, window in TABLE_ROWS:
        cfg = get_config(arch)
        w = cfg.window_size if window is None else window
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = inputs(gen, B, S, h, kv, d)
        runs_of = {n: launcher(fn, q, k, v, w, scratch[n])
                   for n, fn in libs.items()}
        times = {"other": [], "this": []}
        for _ in range(rounds):
            for n in ("other", "this", "this", "other"):
                times[n].append(time_ms(runs_of[n], runs))
        bms, by = bound(B, S, h, kv, d, w)
        med = {n: statistics.median(ts) for n, ts in times.items()}
        yield {"part": "compare", "config": arch, "shape": [B, S, h, kv, d],
               "window": w, "other": str(other), "other_ms": times["other"],
               "this_ms": times["this"], "other_median_ms": med["other"],
               "this_median_ms": med["this"],
               "this_over_other": med["this"] / med["other"],
               "bound_ms": bms, "bound_by": by,
               "max_err": {n: max_err(r(), q, k, v, w)
                           for n, r in runs_of.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--split", type=int, nargs="+", metavar="D")
    ap.add_argument("--old", action="store_true",
                    help="split the kernel of D > 128, at every D")
    ap.add_argument("--compare", type=Path, metavar="OTHER.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_split: no CUDA device")
    torch.set_grad_enabled(False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    parts = []
    if args.sweep:
        parts.append(sweep(gen, args.runs))
    for d in args.split or ():
        parts.append(split(gen, d, args.runs, args.rounds, args.old))
    if args.compare:
        parts.append(compare(gen, args.compare, args.runs, args.rounds))
    for part in parts:
        for rec in part:
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
