"""The port's Mixture-of-Experts FFN (src/repro_torch/models/moe.py)
against the JAX package's (src/repro/models/moe.py) on the CPU, at the
reduced configs of olmoe-1b-7b and qwen3-moe-235b-a22b (d 256, 4
experts, top-2, d_ff_expert 512): capacity, routes, the FFN and its aux
loss, then the model's forward, prefill and decode, the serving engine
and one train step, and, within the port, ``BuiltJob`` at both
single-device techniques and ``measure_serve_step_time``.

Routes are held exactly: the top-k experts in their order, and the
token of every expert slot (which tokens an expert keeps at capacity).
Three routings are compared in fp32: random inputs, a zeroed router
(every probability equal, so the top-k is experts 0..k-1 by the tie
rule, and experts 0 and 1 overflow their capacity of 12 with 16 tokens
each) and a router biased to one expert (that expert overflows).  The
gate weight of a slot is a softmax probability renormalised over the
top-k; XLA's and PyTorch's exp differ in the last bit, so it is held to
atol 1e-6 (measured 1.8e-7, two ulps near 1), and the FFN's output to
atol 1e-4 at |out| up to 20 (measured 1.1e-5).  In bf16 a route is held
exactly on every row whose bf16 router product is bit-equal in the two
packages, and the output on those rows to four bf16 steps of its
largest value (measured 2.1: XLA and PyTorch round the expert products'
intermediates at different points).

The model-level comparisons use the JAX init with wq, wk and wv
rescaled to a fan-in of d_model, as tests/test_torch_model.py does and
for the reason given there; their tolerances are that file's.  The
train step's are tests/test_torch_train.py's for gemma3-4b.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params, np32
from test_torch_model import _rescale
from test_torch_train import OPT, _compare_trees
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import concrete_batch, get_config
from repro_torch.core.library import ParallelismLibrary
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import moe
from repro_torch.models.params import params_to_numpy
from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state,
                                            prefill_forward)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.parallelism.build import BuiltJob
from repro_torch.serving.engine import ContinuousBatchingEngine, Request
from repro_torch.serving.profile import measure_serve_step_time
from repro_torch.train.steps import make_train_step

MOE_ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
W_ATOL = 1e-6          # gate weights, fp32
OUT_ATOL = 1e-4        # the FFN's output, fp32
AUX_RTOL = 1e-6
LOGITS_ATOL = 1e-4     # forward and prefill logits (tests/test_torch_model.py)
DECODE_ATOL = 5e-4


def _cfgs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _ffn_inputs(cfg, routing, b=3, s=16, seed=0):
    """Numpy MoE weights at the init's scales and x (B, S, d)."""
    m, d = cfg.moe, cfg.d_model
    rng = np.random.RandomState(seed)
    e, f = m.num_experts, m.d_ff_expert
    p = {"router": rng.randn(d, e) * 0.1 / np.sqrt(d),
         "wi_gate": rng.randn(e, d, f) / np.sqrt(d),
         "wi_up": rng.randn(e, d, f) / np.sqrt(d),
         "wo": rng.randn(e, f, d) / np.sqrt(f)}
    x = rng.randn(b, s, d) * 3
    if routing == "tie":
        p["router"][:] = 0.0
    elif routing == "overflow":
        x[..., 0] = 5.0                 # every token's logit of expert 2
        p["router"][0, 2] = 1.0         # is raised by 5
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _jax_routes(jcfg, jp, jx, cap):
    """The JAX package's routes: _route_row's (tok_of_slot, w_of_slot)
    for each row, and its top-k (moe.py:48-50)."""
    def row(xr):
        _, tok, w, aux = jmoe._route_row(jp, xr, jcfg, cap)
        probs = jax.nn.softmax((xr @ jp["router"]).astype(jnp.float32), -1)
        return jax.lax.top_k(probs, jcfg.moe.top_k)[1], tok, w, aux
    return [np.asarray(t) for t in jax.vmap(row)(jx)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_matches(arch):
    for cfg_pair in (_cfgs(arch), (jax_get_config(arch), get_config(arch))):
        jcfg, cfg = cfg_pair
        for s in list(range(1, 70)) + [127, 128, 129, 256, 512, 1000, 4096]:
            assert moe.moe_capacity(cfg, s) == jmoe.moe_capacity(jcfg, s)


@pytest.mark.parametrize("routing", ["random", "tie", "overflow"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routes_and_ffn_match_jax(arch, routing):
    jcfg, cfg = _cfgs(arch)
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    p, x = _ffn_inputs(cfg, routing)
    cap = moe.moe_capacity(cfg, x.shape[1])
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: torch.tensor(v) for n, v in p.items()}
    j_top, j_tok, j_w, j_aux = _jax_routes(jcfg, jp, jnp.asarray(x), cap)
    r = moe.route(tp, torch.tensor(x), cfg, cap)
    np.testing.assert_array_equal(r.top_idx.numpy(), j_top)
    np.testing.assert_array_equal(r.tok_of_slot.numpy(), j_tok)
    np.testing.assert_allclose(r.w_of_slot.numpy(), j_w, atol=W_ATOL, rtol=0)
    np.testing.assert_allclose(r.aux.numpy(), j_aux, rtol=AUX_RTOL)
    kept = (r.slot_of_pair >= 0).sum(-1)
    if routing == "tie":
        assert (r.top_idx.numpy() == np.arange(k)).all()
    if routing != "random":              # some (token, k) pairs dropped
        sizes = np.stack([np.bincount(t.reshape(-1), minlength=e)
                          for t in j_top])
        assert (sizes > cap).any() and (kept < k).any()
    j_out, j_aux_mean = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_ffn(tp, torch.tensor(x), cfg)
    np.testing.assert_allclose(np32(out), np32(j_out), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(j_aux_mean), rtol=AUX_RTOL)


def test_slot_of_pair_inverts_the_dispatch():
    """Every kept (token, k) pair names the one slot that holds its token
    and weight, and every filled slot is named by one pair."""
    _, cfg = _cfgs("olmoe-1b-7b")
    p, x = _ffn_inputs(cfg, "overflow", b=2, s=24, seed=1)
    cap = moe.moe_capacity(cfg, 24)
    r = moe.route({n: torch.tensor(v) for n, v in p.items()},
                  torch.tensor(x), cfg, cap)
    for b in range(2):
        filled = set()
        for t in range(24):
            for j in range(cfg.moe.top_k):
                sl = int(r.slot_of_pair[b, t, j])
                if sl < 0:
                    continue
                e, c = divmod(sl, cap)
                assert e == int(r.top_idx[b, t, j])
                assert int(r.tok_of_slot[b, e, c]) == t
                assert float(r.w_of_slot[b, e, c]) > 0.0
                filled.add(sl)
        assert filled == {int(i) for i in
                          torch.nonzero(r.w_of_slot[b].reshape(-1))}


@pytest.mark.parametrize("routing", ["random", "tie"])
def test_bf16_routes_and_ffn_match_jax(routing):
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    p, x = _ffn_inputs(cfg, routing, b=4)
    cap = moe.moe_capacity(cfg, x.shape[1])
    jp = {n: jnp.asarray(v, jnp.bfloat16) for n, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    tp = {n: torch.tensor(np32(v)).bfloat16() for n, v in jp.items()}
    tx = torch.tensor(np32(jx)).bfloat16()
    j_top, j_tok, j_w, _ = _jax_routes(jcfg, jp, jx, cap)
    r = moe.route(tp, tx, cfg, cap)
    same = [np.array_equal(np32(jx[i] @ jp["router"]),
                           np32(tx[i] @ tp["router"])) for i in range(4)]
    assert any(same)
    j_out, _ = jmoe.moe_ffn(jp, jx, jcfg)
    out, _ = moe.moe_ffn(tp, tx, cfg)
    for i in np.flatnonzero(same):
        np.testing.assert_array_equal(r.top_idx[i].numpy(), j_top[i])
        np.testing.assert_array_equal(r.tok_of_slot[i].numpy(), j_tok[i])
        np.testing.assert_allclose(r.w_of_slot[i].numpy(), j_w[i], atol=W_ATOL)
        scale = np.abs(np32(j_out[i])).max()
        np.testing.assert_allclose(np32(out[i]), np32(j_out[i]),
                                   atol=4 * 2 ** -8 * scale, rtol=0)


# ------------------------------------------------------------ the model

def _setup(arch, rescale=True, seed=1):
    jcfg, cfg = _cfgs(arch)
    jparams = jt.init_model(jcfg, jax.random.PRNGKey(seed))
    if rescale:
        jparams = _rescale(jcfg, jparams)
    return jcfg, cfg, jparams, jax_to_torch_params(jparams)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    toks = jax_concrete_batch(jcfg, 2, 16)["tokens"]
    batch = concrete_batch(cfg, 2, 16, device="cpu")
    j_logits, j_aux = jax.jit(lambda p, b: jt.forward(p, jcfg, b))(
        jparams, {"tokens": toks})
    logits, aux = forward(params, cfg, batch)
    np.testing.assert_allclose(np32(logits), np32(j_logits),
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=AUX_RTOL)
    assert float(aux) > 0.0
    j_pl, _ = jax.jit(lambda p, b: jt.prefill_forward(p, jcfg, b))(
        jparams, {"tokens": toks})
    pl, state = prefill_forward(params, cfg, batch)
    np.testing.assert_allclose(np32(pl), np32(j_pl), atol=LOGITS_ATOL)
    assert int(state["pos"]) == 16
    # decode: one token a step, each row routed with capacity 4
    j_state = jt.init_decode_state(jcfg, 2, 8, dtype=jnp.float32)
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    j_step = jax.jit(lambda p, t, s: jt.decode_step(p, jcfg, t, s))
    t8 = np.asarray(toks)[:, :8]
    for i in range(8):
        j_lg, j_state = j_step(jparams, jnp.asarray(t8[:, i:i + 1]), j_state)
        lg, state = decode_step(params, cfg, torch.tensor(t8[:, i:i + 1]),
                                state)
        np.testing.assert_allclose(np32(lg), np32(j_lg), atol=DECODE_ATOL)


def test_decode_matches_forward_on_raw_init():
    """Within the port, on the raw init: teacher-forced decode gives the
    forward's last logits (tests/test_archs_smoke.py's bound), since a
    decode row never reaches capacity and a prefill row of 8 does not
    either at these weights."""
    _, cfg, _, params = _setup("olmoe-1b-7b", rescale=False)
    toks = concrete_batch(cfg, 2, 8, device="cpu")["tokens"]
    full, _ = forward(params, cfg, {"tokens": toks})
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(8):
        lg, state = decode_step(params, cfg, toks[:, i:i + 1], state)
    assert np.abs(np32(lg[:, 0]) - np32(full[:, -1])).max() < 5e-4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_matches_jax_engine(arch):
    jcfg, cfg, jparams, params = _setup(arch, rescale=False, seed=0)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(3, 8)).tolist()
               for _ in range(4)]
    arrivals = [0.0, 0.5, 1.0, 1.5]
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=32)
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                   device="cpu")
    for i, (pr, t) in enumerate(zip(prompts, arrivals)):
        jeng.submit(JaxRequest(rid=i, prompt=pr, max_new_tokens=4,
                               arrival_s=t))
        eng.submit(Request(rid=i, prompt=pr, max_new_tokens=4, arrival_s=t))
    expected = {r.rid: r.output for r in jeng.run()}
    done = eng.run()
    assert len(done) == 4 and eng.steps == jeng.steps
    for r in done:
        assert r.output == expected[r.rid], r.rid


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_jax(arch):
    """One step of lm_loss (cross-entropy + the MoE aux) and AdamW."""
    jcfg, cfg, jparams, params = _setup(arch)
    jbatch = next(JaxSyntheticLM(jcfg, seed=0).batches(2, 16))
    batch = next(SyntheticLM(cfg, seed=0).batches(2, 16, device="cpu"))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**OPT)))
    jp, jo, jm = jstep(jparams, jax_init_opt_state(jparams), jbatch)
    p, o, m = make_train_step(cfg, AdamWConfig(**OPT))(
        params, init_opt_state(params), batch)
    assert set(m) == set(jm) and float(m["aux_loss"]) > 0.0
    for k in jm:
        np.testing.assert_allclose(np32(m[k]), np32(jm[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    _compare_trees(p, jp, 5e-4, "params")
    _compare_trees({"mu": o["mu"], "nu": o["nu"]},
                   {"mu": jo["mu"], "nu": jo["nu"]}, 5e-4, "opt")
    # the router and every expert leaf received a gradient
    for leaf in ("router", "wi_gate", "wi_up", "wo"):
        assert float(o["mu"]["groups"][0]["pos0_attn"]["ffn"][leaf]
                     .abs().max()) > 0.0, leaf


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_built_job_ddp_and_remat_offload_agree(arch):
    """One step at each single-device technique from ``BuiltJob.init``:
    remat recomputes the same routes, so the results are bit-equal."""
    _, cfg = _cfgs(arch)
    batch = next(SyntheticLM(cfg).batches(2, 16, device="cpu"))
    out = {}
    for technique in ("ddp", "remat-offload"):
        plan = ParallelismLibrary().get(technique).plan(cfg, 1)
        job = BuiltJob(cfg, plan, AdamWConfig(**OPT), device="cpu")
        params, opt = job.init(0)
        out[technique] = job.step(params, opt, job.place_batch(batch))
    (pa, oa, ma), (pb, ob, mb) = out.values()
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["aux_loss"]) == float(mb["aux_loss"]) > 0.0
    for a, b in zip(params_to_numpy({"p": pa, "o": oa}).values(),
                    params_to_numpy({"p": pb, "o": ob}).values()):
        np.testing.assert_array_equal(a, b)


def test_measure_serve_step_time_on_cpu():
    dt = measure_serve_step_time(get_config("olmoe-1b-7b"), slots=2,
                                 max_len=16, new_tokens=3, device="cpu")
    assert dt > 0.0
