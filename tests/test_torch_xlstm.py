"""The port's xLSTM against the JAX package at fp32: the causal conv, the
mLSTM and sLSTM blocks (full sequence on each branch, with the kernels'
opts slots, prefill state and decode step), and the model on
xlstm-125m.reduced() and xlstm-micro (the config of
tests/test_backends.py): forward, prefill, greedy decode and the
serving engine; plus the port's own decode-vs-forward check.

Weights are the JAX package's raw init carried across.  Unlike the
attention families (see tests/test_torch_model.py), xLSTM parity at
random init is not chaotic: on the CPU the logits agreed within 7.3e-6
(|logits| <= 3.9) and the blocks within 1.7e-6 * max|y|, so no
projection is rescaled."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params, np32
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.kernels.mlstm_chunk import mlstm_chunk as jax_mlstm_chunk
from repro.kernels.slstm_step import slstm_step_scan as jax_slstm_step
from repro.models import recurrent as jrec
from repro.models import transformer as jt
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.slstm_step import slstm_step_scan
from repro_torch.models import recurrent as rec
from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state,
                                            prefill_forward,
                                            state_batch_axes)
from repro_torch.serving.engine import ContinuousBatchingEngine, Request

BLOCK_REL = 1e-5     # block outputs: err <= 1e-5 * max|y| (measured 1.7e-6)
LOGITS_ATOL = 1e-4   # model logits (measured 7.3e-6)
MICRO = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             name="xlstm-micro")


def _cfgs(name):
    jcfg = jax_get_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    if name == "micro":
        jcfg = dataclasses.replace(jcfg, **MICRO)
        cfg = dataclasses.replace(cfg, **MICRO)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("reduced", "micro"):
        jcfg, cfg = _cfgs(name)
        jparams = jt.init_model(jcfg, jax.random.PRNGKey(1))
        out[name] = (jcfg, cfg, jparams, jax_to_torch_params(jparams))
    return out


def _block_params(jparams, params, key):
    """One layer's mixer params (layer 0 of the stacked group)."""
    jp = jax.tree.map(lambda t: t[0], jparams["groups"][0][key]["mixer"])
    tp = jax.tree.map(lambda t: t[0], params["groups"][0][key]["mixer"])
    return jp, tp


def _close(ours, theirs, rel=BLOCK_REL):
    theirs = np32(theirs)
    err = np.abs(np32(ours) - theirs).max()
    assert err <= rel * np.abs(theirs).max(), (err, np.abs(theirs).max())


def _x(seed, b, s, d):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def test_conv1d_matches_jax(models):
    jcfg, _, jparams, params = models["reduced"]
    jp, tp = _block_params(jparams, params, "pos0_mlstm")
    up = jp["w_up"].shape[1]
    x = _x(0, 2, 16, up)
    _close(rec.conv1d(tp["conv"], torch.tensor(x)),
           jrec.conv1d(jp["conv"], jnp.asarray(x)))
    state = np.random.RandomState(1).randn(2, 3, up).astype(np.float32)
    out, new = rec.conv1d_step(tp["conv"], torch.tensor(x[:, 0]),
                               torch.tensor(state))
    jout, jnew = jrec.conv1d_step(jp["conv"], jnp.asarray(x[:, 0]),
                                  jnp.asarray(state))
    _close(out, jout)
    np.testing.assert_array_equal(np32(new), np32(jnew))


@pytest.mark.parametrize("branch", ["quadratic", "chunked", "kernel"])
def test_mlstm_block_matches_jax(models, branch):
    """S 32 takes the quadratic form, S 1024 the chunked one; "kernel"
    sets parallel_fn to each package's mLSTM kernel (the JAX one in
    interpret mode, the port's plain version on the CPU)."""
    jcfg, cfg, jparams, params = models["reduced"]
    jp, tp = _block_params(jparams, params, "pos0_mlstm")
    s = {"quadratic": 32, "chunked": 1024, "kernel": 256}[branch]
    x = _x(2, 2, s, cfg.d_model)
    jfn = tfn = None
    if branch == "kernel":
        jfn = lambda *a: jax_mlstm_chunk(*a, chunk=64, interpret=True)
        tfn = mlstm_chunk
    jy, _ = jrec.mlstm_block(jp, jnp.asarray(x), jcfg, parallel_fn=jfn)
    y, st = rec.mlstm_block(tp, torch.tensor(x), cfg, parallel_fn=tfn)
    assert st is None
    _close(y, jy)


def test_mlstm_block_prefill_state_and_decode_match_jax(models):
    jcfg, cfg, jparams, params = models["reduced"]
    jp, tp = _block_params(jparams, params, "pos0_mlstm")
    x = _x(3, 2, 64, cfg.d_model)
    jy, jst = jrec.mlstm_block(jp, jnp.asarray(x[:, :63]), jcfg,
                               return_state=True)
    y, st = rec.mlstm_block(tp, torch.tensor(x[:, :63]), cfg,
                            return_state=True)
    _close(y, jy)
    assert st.keys() == jst.keys()
    for name in st:
        assert st[name].dtype == torch.float32
        _close(st[name], jst[name])
    jy1, jst1 = jrec.mlstm_block(jp, jnp.asarray(x[:, 63:]), jcfg, state=jst)
    y1, st1 = rec.mlstm_block(tp, torch.tensor(x[:, 63:]), cfg, state=st)
    _close(y1, jy1)
    for name in st1:
        _close(st1[name], jst1[name])


@pytest.mark.parametrize("kernel", [False, True])
def test_slstm_block_matches_jax(models, kernel):
    """The step scan, and the slstm_fn slot with the port's sLSTM kernel
    (its plain version on the CPU), against the JAX block's scan; and
    the Pallas kernel (interpret mode) computes the same at fp32."""
    jcfg, cfg, jparams, params = models["reduced"]
    jp, tp = _block_params(jparams, params, "pos1_slstm")
    x = _x(4, 2, 64, cfg.d_model)
    jy, _ = jrec.slstm_block(jp, jnp.asarray(x), jcfg)
    y, st = rec.slstm_block(tp, torch.tensor(x), cfg,
                            slstm_fn=slstm_step_scan if kernel else None)
    assert st is None
    _close(y, jy)
    if kernel:
        gates = np.random.RandomState(5).randn(2, 64, 4, 64, 4) * 0.5
        jout = jax_slstm_step(jnp.asarray(gates, jnp.float32),
                              *(jp[k] for k in ("rz", "ri", "rf", "ro")),
                              block_s=32, interpret=True)
        out = slstm_step_scan(torch.tensor(gates, dtype=torch.float32),
                              *(tp[k] for k in ("rz", "ri", "rf", "ro")))
        _close(out, jout)


def test_slstm_block_prefill_state_and_decode_match_jax(models):
    jcfg, cfg, jparams, params = models["reduced"]
    jp, tp = _block_params(jparams, params, "pos1_slstm")
    x = _x(6, 2, 32, cfg.d_model)
    calls = []
    never = lambda *a: calls.append(a)
    jy, jst = jrec.slstm_block(jp, jnp.asarray(x[:, :31]), jcfg,
                               return_state=True)
    # the kernel slot is not taken when a state is asked for
    y, st = rec.slstm_block(tp, torch.tensor(x[:, :31]), cfg,
                            return_state=True, slstm_fn=never)
    assert not calls
    _close(y, jy)
    for name in ("c", "n", "m", "h"):
        _close(st[name], jst[name])
    jy1, jst1 = jrec.slstm_block(jp, jnp.asarray(x[:, 31:]), jcfg, state=jst)
    y1, st1 = rec.slstm_block(tp, torch.tensor(x[:, 31:]), cfg, state=st,
                              slstm_fn=never)
    assert not calls
    _close(y1, jy1)
    for name in st1:
        _close(st1[name], jst1[name])


@pytest.mark.parametrize("seq", [32, 1024])
@pytest.mark.parametrize("name", ["reduced", "micro"])
def test_forward_matches_jax(models, name, seq):
    jcfg, cfg, jparams, params = models[name]
    toks = np.asarray(jax_concrete_batch(jcfg, 2, seq)["tokens"])
    jl, _ = jax.jit(lambda p, b: jt.forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    logits, aux = forward(params, cfg, {"tokens": torch.tensor(toks)})
    assert logits.shape == (2, seq, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(np32(logits), np32(jl), atol=LOGITS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["reduced", "micro"])
def test_prefill_and_greedy_decode_match_jax(models, name):
    """prefill_forward's logits and state, then 6 greedy tokens decoded
    from that state, against the JAX package."""
    jcfg, cfg, jparams, params = models[name]
    toks = np.asarray(jax_concrete_batch(jcfg, 2, 24)["tokens"])
    jl, jst = jax.jit(lambda p, b: jt.prefill_forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    pl, st = prefill_forward(params, cfg, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(np32(pl), np32(jl), atol=LOGITS_ATOL, rtol=0)
    assert int(st["pos"]) == int(jst["pos"]) == 24
    for g, jg in zip(st["layers"], jst["layers"]):
        for key in jg:
            assert g[key].keys() == jg[key].keys()
            for leaf in g[key]:
                _close(g[key][leaf], jg[key][leaf])
    j_step = jax.jit(lambda p, t, s: jt.decode_step(p, jcfg, t, s))
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tok = torch.argmax(pl[:, -1:], dim=-1).to(torch.int32)
    for _ in range(6):
        assert np.array_equal(np.asarray(jtok), tok.numpy())
        jlg, jst = j_step(jparams, jtok, jst)
        lg, st = decode_step(params, cfg, tok, st)
        np.testing.assert_allclose(np32(lg), np32(jlg), atol=LOGITS_ATOL,
                                   rtol=0)
        jtok = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)


@pytest.mark.parametrize("name", ["reduced", "micro"])
def test_decode_matches_forward(models, name):
    """Within the port: teacher-forced decode reproduces the forward's
    last logits (the bound of tests/test_archs_smoke.py), and prefill
    the forward's."""
    _, cfg, _, params = models[name]
    toks = torch.tensor(np.asarray(jax_concrete_batch(
        models[name][0], 2, 8)["tokens"]))
    full, _ = forward(params, cfg, {"tokens": toks})
    pl, _ = prefill_forward(params, cfg, {"tokens": toks})
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(8):
        lg, state = decode_step(params, cfg, toks[:, i:i + 1], state)
    assert np.abs(np32(lg[:, 0]) - np32(full[:, -1])).max() < 5e-4
    assert np.abs(np32(pl[:, 0]) - np32(full[:, -1])).max() < 1e-4


def test_decode_state_layout():
    """Every recurrent leaf has its batch axis where state_batch_axes
    says (1 under the scanned group), and the stabilizers start at
    -1e30, as the JAX package's init_decode_state gives them."""
    jcfg, cfg = _cfgs("reduced")
    ours = init_decode_state(cfg, 3, 8, dtype=torch.float32, device="cpu")
    theirs = jt.init_decode_state(jcfg, 3, 8, dtype=jnp.float32)
    axes = state_batch_axes(cfg)
    for g, jg, ax in zip(ours["layers"], theirs["layers"], axes["layers"]):
        for key in jg:
            assert g[key].keys() == jg[key].keys() == ax[key].keys()
            for leaf in g[key]:
                t = g[key][leaf]
                assert t.shape[ax[key][leaf]] == 3
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(np32(t), np32(jg[key][leaf]))
    assert axes["pos"] == 0


def test_engine_matches_jax_engine(models):
    """Staggered requests on 2 slots: same steps, same greedy tokens as
    the JAX engine (frozen slots' recurrent state is spliced, reused
    slots are reset)."""
    jcfg, cfg, jparams, params = models["reduced"]
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
