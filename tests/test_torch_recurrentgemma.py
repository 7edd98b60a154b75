"""The port's RecurrentGemma against the JAX package at fp32 on
recurrentgemma-2b.reduced() (3 layers: RG-LRU, RG-LRU, window-32
attention; d 256, 4 query heads and 1 KV head): the RG-LRU block (full
sequence on the plain scan and through each package's kernel, prefill
state, one decode step), the forward past the window, the port's plain
path against the JAX kernel path, prefill plus greedy decode, the
serving engine, and the port's own decode-vs-forward check.

Against the JAX package the weights are its init with wq, wk and wv
rescaled to a fan-in of d_model (see tests/test_torch_model.py): with
one KV head the raw init draws wk and wv at fan-in 1, softmax is sharp,
and 1-ulp differences between XLA's and PyTorch's rsqrt and sin/cos
reach the logits as gaps of up to 3e-4 at S 300 (measured on the CPU;
6.3e-6 rescaled).  The RG-LRU block itself is compared on the raw
init.  The port's own consistency checks run on the raw init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params, np32
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.kernels.ops import kernel_opts as jax_kernel_opts
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.models import recurrent as jrec
from repro.models import transformer as jt
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models import recurrent as rec
from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state,
                                            prefill_forward,
                                            state_batch_axes)
from repro_torch.serving.engine import ContinuousBatchingEngine, Request
from repro_torch.serving.profile import measure_serve_step_time

ARCH = "recurrentgemma-2b"
BLOCK_REL = 1e-5     # block outputs and states: err <= 1e-5 * max|ref|
LOGITS_ATOL = 1e-4   # model logits, rescaled weights (measured 6.3e-6)


def _rescale(cfg, params):
    def fix(path, t):
        heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads,
                 "wv": cfg.num_kv_heads}.get(getattr(path[-1], "key", None))
        return t if heads is None else t * np.sqrt(heads / cfg.d_model)
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    raw = jt.init_model(jcfg, jax.random.PRNGKey(1))
    scaled = _rescale(jcfg, raw)
    return {"cfg": (jcfg, cfg),
            "raw": (raw, jax_to_torch_params(raw)),
            "scaled": (scaled, jax_to_torch_params(scaled))}


def _block_params(models):
    """Layer 0's RG-LRU mixer params (of the stacked group)."""
    jparams, params = models["raw"]
    key = "pos0_rglru"
    jp = jax.tree.map(lambda t: t[0], jparams["groups"][0][key]["mixer"])
    tp = jax.tree.map(lambda t: t[0], params["groups"][0][key]["mixer"])
    return jp, tp


def _close(ours, theirs, rel=BLOCK_REL):
    theirs = np32(theirs)
    err = np.abs(np32(ours) - theirs).max()
    assert err <= rel * np.abs(theirs).max(), (err, np.abs(theirs).max())


def _x(seed, b, s, d):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def _tokens(jcfg, b, s):
    return np.asarray(jax_concrete_batch(jcfg, b, s)["tokens"])


@pytest.mark.parametrize("kernel", [False, True])
def test_rglru_block_matches_jax(models, kernel):
    """The plain scan, and scan_fn set to each package's RG-LRU kernel
    (the JAX one in interpret mode, the port's plain version on the
    CPU), at S 256."""
    jcfg, cfg = models["cfg"]
    jp, tp = _block_params(models)
    x = _x(0, 2, 256, cfg.d_model)
    jfn = tfn = None
    if kernel:
        jfn = lambda a, b: jax_rglru_scan(a, b, block_s=64, interpret=True)
        tfn = rglru_scan
    jy, _ = jax.jit(lambda p_, x_: jrec.rglru_block(p_, x_, jcfg,
                                                    scan_fn=jfn))(
        jp, jnp.asarray(x))
    y, st = rec.rglru_block(tp, torch.tensor(x), cfg, scan_fn=tfn)
    assert st is None
    _close(y, jy)


def test_rglru_block_prefill_state_and_decode_match_jax(models):
    """The prefill state (h of the last step in fp32, the conv tail) and
    one decode step from it; the scan is taken when a state is asked
    for, as in the reference."""
    jcfg, cfg = models["cfg"]
    jp, tp = _block_params(models)
    x = _x(1, 2, 40, cfg.d_model)
    calls = []
    counted = lambda a, b: calls.append(1) or rglru_scan(a, b)
    jy, jst = jax.jit(lambda p_, x_: jrec.rglru_block(
        p_, x_, jcfg, return_state=True))(jp, jnp.asarray(x[:, :39]))
    y, st = rec.rglru_block(tp, torch.tensor(x[:, :39]), cfg,
                            return_state=True, scan_fn=counted)
    assert calls == [1]
    _close(y, jy)
    assert st.keys() == jst.keys() == {"h", "conv"}
    assert st["h"].dtype == torch.float32
    assert tuple(st["h"].shape) == (2, cfg.resolved_d_rnn)
    assert tuple(st["conv"].shape) == (2, cfg.conv_width - 1,
                                       cfg.resolved_d_rnn)
    for name in st:
        _close(st[name], jst[name])
    jy1, jst1 = jrec.rglru_block(jp, jnp.asarray(x[:, 39:]), jcfg, state=jst)
    y1, st1 = rec.rglru_block(tp, torch.tensor(x[:, 39:]), cfg, state=st,
                              scan_fn=counted)
    assert calls == [1]                      # decode runs no scan
    _close(y1, jy1)
    assert st1["h"].dtype == torch.float32
    for name in st1:
        _close(st1[name], jst1[name])


@pytest.mark.parametrize("seq", [32, 300])
def test_forward_matches_jax(models, seq):
    """S 32 fills the window; S 300 runs past it and is not a multiple
    of the Pallas kernels' blocks."""
    jcfg, cfg = models["cfg"]
    jparams, params = models["scaled"]
    toks = _tokens(jcfg, 2, seq)
    jl, _ = jax.jit(lambda p, b: jt.forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    logits, aux = forward(params, cfg, {"tokens": torch.tensor(toks)})
    assert logits.shape == (2, seq, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(np32(logits), np32(jl), atol=LOGITS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("port_kernels", [False, True])
def test_port_matches_jax_kernel_path(models, port_kernels):
    """The JAX forward through its Pallas kernels (interpret mode) at
    S 256, against the port's plain path (opts={}) and the port's kernel
    wrappers (their plain versions on the CPU)."""
    jcfg, cfg = models["cfg"]
    jparams, params = models["scaled"]
    toks = _tokens(jcfg, 2, 256)
    jopts = jax_kernel_opts(force=True, interpret=True)
    jl, _ = jax.jit(lambda p, b: jt.forward(p, jcfg, b, opts=jopts))(
        jparams, {"tokens": jnp.asarray(toks)})
    opts = ({"attn_fn": flash_attention, "rglru_scan": rglru_scan}
            if port_kernels else {})
    logits, _ = forward(params, cfg, {"tokens": torch.tensor(toks)},
                        opts=opts)
    np.testing.assert_allclose(np32(logits), np32(jl), atol=LOGITS_ATOL,
                               rtol=0)


def test_prefill_and_greedy_decode_match_jax(models):
    """prefill_forward's logits and state, then 6 greedy tokens decoded
    from that state, against the JAX package."""
    jcfg, cfg = models["cfg"]
    jparams, params = models["scaled"]
    toks = _tokens(jcfg, 2, 40)
    jl, jst = jax.jit(lambda p, b: jt.prefill_forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    pl, st = prefill_forward(params, cfg, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(np32(pl), np32(jl), atol=LOGITS_ATOL, rtol=0)
    assert int(st["pos"]) == int(jst["pos"]) == 40
    for g, jg in zip(st["layers"], jst["layers"]):
        for key in jg:
            assert g[key].keys() == jg[key].keys()
            for leaf in g[key]:
                _close(g[key][leaf], jg[key][leaf])
    # a decode state of length 46 seeded with the prefill's (as the
    # serving path does): KV caches along their sequence axis, recurrent
    # leaves whole
    jstate = jt.init_decode_state(jcfg, 2, 46, dtype=jnp.float32)
    state = init_decode_state(cfg, 2, 46, dtype=torch.float32, device="cpu")
    for gi, g in enumerate(st["layers"]):
        for key, leaves in g.items():
            for leaf, src in leaves.items():
                dst = state["layers"][gi][key][leaf]
                dst[tuple(slice(0, n) for n in src.shape)] = src
                jdst = jstate["layers"][gi][key][leaf]
                jstate["layers"][gi][key][leaf] = jdst.at[
                    tuple(slice(0, n) for n in src.shape)].set(
                        jst["layers"][gi][key][leaf])
    state["pos"] = st["pos"]
    jstate["pos"] = jst["pos"]
    j_step = jax.jit(lambda p, t, s: jt.decode_step(p, jcfg, t, s))
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tok = torch.argmax(pl[:, -1:], dim=-1).to(torch.int32)
    for _ in range(6):
        assert np.array_equal(np.asarray(jtok), tok.numpy())
        jlg, jstate = j_step(jparams, jtok, jstate)
        lg, state = decode_step(params, cfg, tok, state)
        np.testing.assert_allclose(np32(lg), np32(jlg), atol=LOGITS_ATOL,
                                   rtol=0)
        jtok = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)


def test_decode_matches_forward(models):
    """Within the port, on the raw init: teacher-forced decode
    reproduces the forward's last logits (the bound of
    tests/test_archs_smoke.py), and prefill the forward's."""
    jcfg, cfg = models["cfg"]
    _, params = models["raw"]
    toks = torch.tensor(_tokens(jcfg, 2, 8))
    full, _ = forward(params, cfg, {"tokens": toks})
    pl, _ = prefill_forward(params, cfg, {"tokens": toks})
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(8):
        lg, state = decode_step(params, cfg, toks[:, i:i + 1], state)
    assert np.abs(np32(lg[:, 0]) - np32(full[:, -1])).max() < 5e-4
    assert np.abs(np32(pl[:, 0]) - np32(full[:, -1])).max() < 1e-4


def test_decode_state_layout(models):
    """The RG-LRU leaves are h (B, R) in float32 whatever the model's
    dtype and conv (B, width - 1, R) in it; every leaf has its batch
    axis where state_batch_axes says, and equals the JAX package's."""
    jcfg, cfg = models["cfg"]
    ours = init_decode_state(cfg, 3, 8, dtype=torch.bfloat16, device="cpu")
    theirs = jt.init_decode_state(jcfg, 3, 8, dtype=jnp.bfloat16)
    axes = state_batch_axes(cfg)
    r = cfg.resolved_d_rnn
    g, jg, ax = ours["layers"][0], theirs["layers"][0], axes["layers"][0]
    assert g.keys() == jg.keys() == ax.keys()
    for key in jg:
        assert g[key].keys() == jg[key].keys() == ax[key].keys()
        for leaf in g[key]:
            t = g[key][leaf]
            assert t.shape[ax[key][leaf]] == 3
            assert tuple(t.shape) == jg[key][leaf].shape
            np.testing.assert_array_equal(np32(t), np32(jg[key][leaf]))
    assert g["pos0_rglru"]["h"].dtype == torch.float32
    assert tuple(g["pos0_rglru"]["h"].shape) == (1, 3, r)
    assert g["pos0_rglru"]["conv"].dtype == torch.bfloat16
    assert tuple(g["pos1_rglru"]["conv"].shape) == (1, 3, cfg.conv_width - 1,
                                                    r)
    assert axes["pos"] == 0


def test_engine_matches_jax_engine(models):
    """Staggered requests on 2 slots: same steps, same greedy tokens as
    the JAX engine (frozen slots' recurrent state is spliced, reused
    slots are reset)."""
    jcfg, cfg = models["cfg"]
    jparams, params = models["scaled"]
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(3, 8)).tolist()
               for _ in range(4)]
    arrivals = [0.0, 0.5, 1.0, 1.5]
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=32)
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                   device="cpu")
    for i, (p, t) in enumerate(zip(prompts, arrivals)):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=4,
                               arrival_s=t))
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=4, arrival_s=t))
    expected = {r.rid: r.output for r in jeng.run()}
    done = eng.run()
    assert len(done) == 4 and eng.steps == jeng.steps
    for r in done:
        assert r.output == expected[r.rid], r.rid


def test_measure_serve_step_time_on_cpu():
    dt = measure_serve_step_time(get_config(ARCH), slots=2, max_len=16,
                                 new_tokens=3, device="cpu")
    assert dt > 0.0
