"""The port's AdamW (src/repro_torch/optim/adamw.py) against the JAX
package's: the learning-rate schedules across warmup and decay, and one
update on a tree with a float32 and a bfloat16 leaf, with global-norm
clipping active and inactive.

Tolerances: the learning rate within rtol 1e-6 plus 2e-7 * lr: XLA's
and PyTorch's cos may differ by an ulp of the decay factor, which
0.5 * (1 + cos) near the end of the cosine turns into a relative error
of up to 2e-5 of a rate near 0 (measured 8.9e-12 at lr 3e-4, that is
3e-8 * lr); grad_norm within rtol 1e-6; parameters, mu and nu (float32)
within rtol 2e-6 (measured: parameters bit-equal, nu 3.3e-7 once the
clip scale differs by an ulp); the bf16 parameter within one bf16 ulp
of its value (rtol 2**-8; measured bit-equal); the int32 step exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np32
from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

RTOL = 1e-6


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-4, schedule=schedule, warmup_steps=10, total_steps=50)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in [0, 1, 5, 9, 10, 11, 25, 49, 50, 70]:
        want = np32(jadamw.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
        got = adamw.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(np32(got), want, rtol=RTOL,
                                   atol=2e-7 * cfg.lr)
        np.testing.assert_allclose(np32(adamw.lr_at(cfg, step)), want,
                                   rtol=RTOL, atol=2e-7 * cfg.lr)


def _tree(seed, scale):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(4, 3) * scale).astype(np.float32),
            "blocks": [{"b": (rng.randn(5) * scale).astype(np.float32)},
                       {"b": (rng.randn(5) * scale).astype(np.float32)}],
            "lo": (rng.randn(6) * scale).astype(np.float32)}


def _to_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["lo"] = out["lo"].astype(jnp.bfloat16)
    return out


def _to_torch(tree):
    out = jax.tree.map(torch.tensor, tree)
    out["lo"] = out["lo"].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("clip", ["active", "inactive", "off"])
def test_adamw_update_matches_jax(clip):
    """Two updates from a zero state (bias corrections at t 1 and 2);
    gradients of norm about 4.6 against a clip of 1 (active), 100
    (inactive) or 0 (clipping off)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip={"active": 1.0, "inactive": 100.0, "off": 0.0}[clip])
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p_np = _tree(0, 1.0)
    jp, tp = _to_jax(p_np), _to_torch(p_np)
    jst, tst = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    assert tst["step"].dtype == torch.int32
    assert tst["mu"]["lo"].dtype == torch.float32
    for seed in (1, 2):
        g_np = _tree(seed, 1.0)
        jp, jst, jm = jadamw.adamw_update(jcfg, jp, _to_jax(g_np), jst)
        tp, tst, tm = adamw.adamw_update(cfg, tp, _to_torch(g_np), tst)
        np.testing.assert_allclose(np32(tm["grad_norm"]),
                                   np32(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(np32(tm["lr"]), np32(jm["lr"]),
                                   rtol=RTOL, atol=2e-7 * cfg.lr)
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == 2
    assert int(jst["step"]) == 2
    assert tp["lo"].dtype == torch.bfloat16
    flat_j = jax.tree_util.tree_leaves_with_path({"p": jp, "mu": jst["mu"],
                                                  "nu": jst["nu"]})
    flat_t = {"p": tp, "mu": tst["mu"], "nu": tst["nu"]}
    for path, want in flat_j:
        got = flat_t
        for part in path:
            got = got[part.key if hasattr(part, "key") else part.idx]
        rtol = 2.0 ** -8 if got.dtype == torch.bfloat16 else 2e-6
        np.testing.assert_allclose(np32(got), np32(want), rtol=rtol,
                                   atol=0, err_msg=str(path))


def test_global_norm_matches_jax():
    tree = _tree(3, 2.0)
    np.testing.assert_allclose(np32(adamw.global_norm(_to_torch(tree))),
                               np32(jadamw.global_norm(_to_jax(tree))),
                               rtol=RTOL)
