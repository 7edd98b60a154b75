"""Shared by tests/test_torch_dryrun_*.py: the port's dry run held against
the reference's on small meshes.

For each mesh, the reference's ``launch.dryrun.build_lowerable`` is
compiled on 8 host devices in a subprocess (``jax.sharding.Mesh`` over
them) and read by its loop-aware ``analyze_hlo``; the port's
``build_lowerable`` is traced as rank 0 through ``analyze_step`` with a
fake group of 8.  Both count the same flops (2·M·N·K over the matmuls),
so a combination agrees within FLOPS_REL.  Train and prefill are held
for ARCHS; decode, one greedy step against L 64 caches placed by
``cache_shardings`` under a cache policy, for DECODE_ARCHS under both
policies at B 16 and, for the long-context ones, at B 1.  Collectives
and peak bytes are not gated: run this file to print them side by side

    PYTHONPATH=src:tests python tests/_torch_dryrun.py
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["h2o-danube-3-4b", "olmoe-1b-7b", "recurrentgemma-2b",
         "xlstm-125m"]
MODES = ["train", "prefill"]
# decode (tests/test_torch_dryrun_decode_*.py): L 64 (SEQ) caches placed
# by cache_shardings under each policy
DECODE_ARCHS = ["h2o-danube-3-4b", "olmoe-1b-7b", "recurrentgemma-2b",
                "stablelm-12b"]
POLICIES = ["heads", "seq"]
# name -> (mesh shape, axis names, multi_pod, global batch); S 64
MESHES = {"2x4": ((2, 4), ("data", "model"), False, 16),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), True, 16),
          "2x2x2-b32": ((2, 2, 2), ("pod", "data", "model"), True, 32)}
SEQ = 64
FLOPS_REL = 0.05

_REFERENCE = r'''
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch.dryrun import build_lowerable
from repro.launch.hlo_analysis import analyze
from repro.models.config import InputShape
combos, (shape, names, multi_pod, _), seq = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), tuple(names))
out = {}
for arch, mode, policy, batch in combos:
    cfg = get_config(arch).reduced(num_layers=4)
    fn, args, in_sh = build_lowerable(
        cfg, InputShape("x", seq, batch, mode), mesh, multi_pod,
        cache_policy=policy)
    with mesh:
        c = jax.jit(fn, in_shardings=in_sh).lower(*args).compile()
    h = analyze(c.as_text())
    ma = c.memory_analysis()
    out["|".join(map(str, (arch, mode, policy, batch)))] = {
        "flops": h["flops"], "collectives": h["collectives"],
        "argument_bytes": ma.argument_size_in_bytes,
        "temp_bytes": ma.temp_size_in_bytes,
        "output_bytes": ma.output_size_in_bytes}
print(json.dumps(out))
'''


def _compiled(mesh, combos):
    """The reference's numbers on ``mesh`` for each (arch, mode,
    cache policy, batch) of ``combos``, keyed by them joined with |."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps([combos, MESHES[mesh], SEQ])
    out = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def reference(mesh, archs=ARCHS):
    """The reference's numbers on ``mesh`` for ``archs`` and every
    mode, at the mesh's batch, keyed by arch|mode."""
    batch = MESHES[mesh][3]
    got = _compiled(mesh, [[a, m, "heads", batch]
                           for a in archs for m in MODES])
    return {f"{a}|{m}": got[f"{a}|{m}|heads|{batch}"]
            for a in archs for m in MODES}


def decode_combos(archs=DECODE_ARCHS):
    """(arch, policy, batch) of the decode comparison: both policies at
    B 16, and at B 1 for the long-context archs."""
    from repro_torch.configs import get_config
    return [(a, p, b) for a in archs for p in POLICIES
            for b in ((16, 1) if get_config(a).long_context else (16,))]


def reference_decode(mesh, combos=None):
    """The reference's decode numbers on ``mesh``, keyed by
    arch|policy|batch."""
    combos = combos or decode_combos()
    got = _compiled(mesh, [[a, "decode", p, b] for a, p, b in combos])
    return {f"{a}|{p}|{b}": got[f"{a}|decode|{p}|{b}"]
            for a, p, b in combos}


def port(arch, mode, mesh, cache_policy="heads", batch=None):
    """Rank 0's analysis of the port's dry-run function, and its
    argument bytes (at the mesh's batch unless ``batch``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _nbytes, build_lowerable
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models.config import InputShape
    shape, names, multi_pod, b = MESHES[mesh]
    fn, args, plan = build_lowerable(
        get_config(arch).reduced(num_layers=4),
        InputShape("x", SEQ, batch or b, mode), tuple(zip(names, shape)),
        multi_pod, cache_policy=cache_policy)
    got = analyze_step(fn, args, world_size=plan.n_devices)
    got["argument_bytes"] = _nbytes(args)
    return got


def main():
    print("| mesh | arch | mode | flops port / ref | collectives port "
          "(MB) | collectives ref (MB) | port args / peak (MB) | ref args "
          "/ temp / out (MB) |")
    print("|---|---|---|---|---|---|---|---|")
    mb = lambda x: f"{x / 1e6:.2f}"
    coll = lambda c: ", ".join(f"{k} {mb(v)}" for k, v in sorted(c.items()))

    def row(mesh, name, mode, p, r):
        print(f"| {mesh} | {name} | {mode} | "
              f"{p['flops'] / r['flops']:.4f} | "
              f"{coll(p['collectives'])} | {coll(r['collectives'])} "
              f"| {mb(p['argument_bytes'])} / {mb(p['peak_bytes'])} "
              f"| {mb(r['argument_bytes'])} / {mb(r['temp_bytes'])} "
              f"/ {mb(r['output_bytes'])} |", flush=True)
    for mesh in MESHES:
        ref = reference(mesh)
        for arch in ARCHS:
            for mode in MODES:
                row(mesh, arch, mode, port(arch, mode, mesh),
                    ref[f"{arch}|{mode}"])
        if mesh == "2x2x2-b32":
            continue
        combos = decode_combos() + ([(a, p, 32) for a in DECODE_ARCHS
                                     for p in POLICIES]
                                    if mesh == "2x2x2" else [])
        ref = reference_decode(mesh, combos)
        for arch, policy, b in combos:
            row(mesh, f"{arch} B {b}", f"decode {policy}",
                port(arch, "decode", mesh, policy, b),
                ref[f"{arch}|{policy}|{b}"])


if __name__ == "__main__":
    main()
