"""How often the port's quadratic mLSTM oracle falls outside the bound of
``test_mlstm_oracles_match_jax`` against the JAX package's, over fresh
processes, for a given PyTorch thread count.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/probe_mlstm_oracle_threads.py \\
        --threads 8 --procs 40 --parallel 4

Each child process sets PyTorch's thread count, runs the JAX oracle and
then the port's on the test's inputs (seed 2; B 2, S 256, H 2, D 32) and
prints the worst |port - jax| / (1e-5 + 2e-3 |jax|); the parent prints
each child's value and how many exceeded 1.  Running children in
parallel loads the machine, as several pytest workers do.  Not a test:
pytest does not collect it.
"""
import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def child(threads: int) -> None:
    import torch
    torch.set_num_threads(threads)
    import jax.numpy as jnp
    import numpy as np

    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ref

    rng = np.random.RandomState(2)
    xs = [rng.randn(2, 256, 2, 32).astype(np.float32) for _ in range(3)]
    xs.append(rng.randn(2, 256, 2).astype(np.float32))
    xs.append((rng.randn(2, 256, 2) * 2 + 2).astype(np.float32))
    want = np.asarray(jax_ref.mlstm_ref(*(jnp.asarray(x) for x in xs)))
    got = ref.mlstm_ref(*(torch.from_numpy(x) for x in xs)).numpy()
    print(float(np.max(np.abs(got - want) / (1e-5 + 2e-3 * np.abs(want)))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--procs", type=int, default=40)
    p.add_argument("--parallel", type=int, default=4)
    p.add_argument("--child", action="store_true")
    args = p.parse_args()
    if args.child:
        child(args.threads)
        return 0

    def run(_):
        out = subprocess.run([sys.executable, __file__, "--child",
                              "--threads", str(args.threads)],
                             capture_output=True, text=True, check=True)
        return float(out.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        worst = list(pool.map(run, range(args.procs)))
    print("worst ratio per process:", ", ".join(f"{w:.4f}" for w in worst))
    print(f"threads {args.threads}: {sum(w > 1 for w in worst)} of "
          f"{len(worst)} processes beyond the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
