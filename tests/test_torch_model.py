"""End-to-end parity of the port's transformer with the JAX package at
the sizes of tests/test_archs_smoke.py (B 2, S 8): forward and prefill
logits, decode with a scalar and with a per-row pos, prefill-seeded
decode against teacher-forced decode, and the plain S >= 2048 path.

Against the JAX package the weights are its init with wq, wk and wv
rescaled to a fan-in of d_model (see tests/test_torch_blocks.py): the
raw init makes q and k ~sqrt(d / heads) too large, and the sharp softmax
turns 1-ulp differences between XLA's and PyTorch's rsqrt and sin/cos
into logit gaps of up to 1e-3 at S 8.  The port's own consistency checks
(decode against forward, prefill-seeded against teacher-forced) run on
the raw init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params, np32
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import transformer as jt
from repro_torch.configs import concrete_batch, get_config
from repro_torch.models import layers
from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state,
                                            prefill_forward)

CASES = {
    "gemma3-4b": dict(num_layers=2),       # one scanned group of 6
    "gemma3-4b-10": dict(num_layers=10),   # scanned group + unrolled rest
    "h2o-danube-3-4b": dict(num_layers=2),  # swa only, untied unembed
}


def _rescale(cfg, params):
    def fix(path, t):
        heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads,
                 "wv": cfg.num_kv_heads}.get(path[-1].key)
        return t if heads is None else t * np.sqrt(heads / cfg.d_model)
    return jax.tree_util.tree_map_with_path(fix, params)


def _setup(case, rescale=True):
    arch = case.removesuffix("-10")
    jcfg = jax_get_config(arch).reduced(**CASES[case])
    cfg = get_config(arch).reduced(**CASES[case])
    jparams = jt.init_model(jcfg, jax.random.PRNGKey(1))
    if rescale:
        jparams = _rescale(jcfg, jparams)
    return jcfg, cfg, jparams, jax_to_torch_params(jparams)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_prefill_match_jax(case):
    jcfg, cfg, jparams, params = _setup(case)
    toks = jax_concrete_batch(jcfg, 2, 8)["tokens"]
    batch = concrete_batch(cfg, 2, 8, device="cpu")
    j_logits, _ = jax.jit(lambda p, b: jt.forward(p, jcfg, b))(
        jparams, {"tokens": toks})
    logits, aux = forward(params, cfg, batch)
    np.testing.assert_allclose(np32(logits), np32(j_logits), atol=1e-4)
    assert float(aux) == 0.0
    j_pl, j_state = jax.jit(lambda p, b: jt.prefill_forward(p, jcfg, b))(
        jparams, {"tokens": toks})
    pl, state = prefill_forward(params, cfg, batch)
    np.testing.assert_allclose(np32(pl), np32(j_pl), atol=1e-4)
    assert int(state["pos"]) == int(j_state["pos"]) == 8
    for g, jg in zip(state["layers"], j_state["layers"]):
        for key in jg:
            for name in ("k", "v"):
                np.testing.assert_allclose(np32(g[key][name]),
                                           np32(jg[key][name]), atol=1e-4)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("case", ["gemma3-4b", "gemma3-4b-10"])
def test_decode_matches_jax(case, per_row):
    jcfg, cfg, jparams, params = _setup(case)
    toks = np.asarray(jax_concrete_batch(jcfg, 2, 8)["tokens"])
    j_state = jt.init_decode_state(jcfg, 2, 8, dtype=jnp.float32,
                                   per_row_pos=per_row)
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32,
                              per_row_pos=per_row, device="cpu")
    j_full, _ = jax.jit(lambda p, b: jt.forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    j_step = jax.jit(lambda p, t, s: jt.decode_step(p, jcfg, t, s))
    for i in range(toks.shape[1]):
        j_lg, j_state = j_step(jparams, jnp.asarray(toks[:, i:i + 1]),
                               j_state)
        lg, state = decode_step(params, cfg, torch.tensor(toks[:, i:i + 1]),
                                state)
        np.testing.assert_allclose(np32(lg), np32(j_lg), atol=5e-4)
    assert state["pos"].shape == ((2,) if per_row else ())
    assert np.abs(np32(lg[:, 0]) - np32(j_full[:, -1])).max() < 5e-4


@pytest.mark.parametrize("case", ["gemma3-4b", "gemma3-4b-10"])
def test_decode_matches_forward_on_raw_init(case):
    """Within the port, on the raw init: decode reproduces the forward's
    last logits (the bound of tests/test_archs_smoke.py)."""
    _, cfg, _, params = _setup(case, rescale=False)
    toks = concrete_batch(cfg, 2, 8, device="cpu")["tokens"]
    full, _ = forward(params, cfg, {"tokens": toks})
    pl, _ = prefill_forward(params, cfg, {"tokens": toks})
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(8):
        lg, state = decode_step(params, cfg, toks[:, i:i + 1], state)
    assert np.abs(np32(lg[:, 0]) - np32(full[:, -1])).max() < 5e-4
    assert np.abs(np32(pl[:, 0]) - np32(full[:, -1])).max() < 1e-4


@pytest.mark.parametrize("case", ["gemma3-4b", "gemma3-4b-10"])
def test_prefill_seeded_decode_equals_teacher_forced(case):
    _, cfg, _, params = _setup(case, rescale=False)
    toks = concrete_batch(cfg, 2, 8, device="cpu")["tokens"]
    _, pstate = prefill_forward(params, cfg, {"tokens": toks[:, :5]})
    seeded = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for g, pg in zip(seeded["layers"], pstate["layers"]):
        for key in pg:
            for name, t in pg[key].items():
                g[key][name].narrow(t.ndim - 3, 0, 5).copy_(t)
    seeded["pos"] = pstate["pos"]
    forced = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(5):
        _, forced = decode_step(params, cfg, toks[:, i:i + 1], forced)
    for i in range(5, 8):
        a, seeded = decode_step(params, cfg, toks[:, i:i + 1], seeded)
        b, forced = decode_step(params, cfg, toks[:, i:i + 1], forced)
        np.testing.assert_allclose(np32(a), np32(b), atol=5e-4)
    assert int(seeded["pos"]) == int(forced["pos"]) == 8


@pytest.mark.parametrize("window", [0, 512])
def test_long_sequence_attention_matches_jax(window):
    """At S >= 2048 the plain path is blockwise attention."""
    jcfg = jax_get_config("gemma3-4b").reduced()
    cfg = get_config("gemma3-4b").reduced()
    rng = np.random.RandomState(3)
    p = {"wq": rng.randn(256, 4, 64), "wk": rng.randn(256, 4, 64),
         "wv": rng.randn(256, 4, 64), "wo": rng.randn(4, 64, 256)}
    p = {k: (v / np.sqrt(256)).astype(np.float32) for k, v in p.items()}
    x = rng.randn(1, 2048, 256).astype(np.float32)
    j_y, _ = jax_layers.attention({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), jcfg, window=window)
    y, _ = layers.attention({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x), cfg, window=window)
    np.testing.assert_allclose(np32(y), np32(j_y), atol=1e-4, rtol=1e-4)
