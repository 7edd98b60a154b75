"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode tokens step-by-step against the KV/recurrent-state cache (the
serve_step the decode dry-run shapes trace), as
``examples/serve_batch.py`` runs it on the JAX package.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch gemma3-4b

--device cuda (the default) serves on the first card; --device cpu on
the CPU.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import concrete_batch, get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_decode_state, init_model
from repro_torch.train.steps import make_serve_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config(args.arch).reduced()
    params = init_model(cfg, seed=0, device=dev)
    prompts = concrete_batch(cfg, args.batch, args.prompt_len,
                             device=dev)["tokens"]
    max_len = args.prompt_len + args.gen

    # a decode over a max_len cache, teacher-forced through the prompt,
    # so generation can append
    t0 = time.time()
    state = init_decode_state(cfg, args.batch, max_len, dtype=torch.float32,
                              device=dev)
    serve = make_serve_step(cfg)
    for i in range(args.prompt_len):          # teacher-forced warm-up
        tok = prompts[:, i:i + 1]
        nxt, logits, state = serve(params, tok, state)
    sync()
    t_prefill = time.time() - t0

    toks = [nxt]
    t0 = time.time()
    for _ in range(args.gen - 1):
        nxt, logits, state = serve(params, nxt, state)
        toks.append(nxt)
    sync()
    t_decode = time.time() - t0
    out = torch.cat(toks, dim=1)
    print(f"arch={cfg.name} batch={args.batch}")
    print(f"prompt warm-up: {t_prefill:.2f}s; decode: "
          f"{args.gen - 1} steps in {t_decode:.2f}s "
          f"({(args.gen - 1) * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print("generated ids (row 0):", out[0][:16].tolist(), "...")


if __name__ == "__main__":
    main()
