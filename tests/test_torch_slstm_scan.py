"""The port's batched-gradient sLSTM scan (src/repro_torch/models/
slstm_scan.py) against the JAX package's custom VJP and against autograd
through the port's plain step loop.

- The model (xlstm-125m.reduced(num_layers=4), B 2, S 32: the setup of
  tests/test_slstm_scan.py): every parameter's gradient at that test's
  atol 5e-6 / rtol 1e-3 (measured on the CPU: at most 0.81 of the bound
  against the JAX package, 0.09 against the port's step loop); logits at
  its atol 1e-5 / rtol 1e-5 against the step loop, and at
  tests/test_torch_xlstm.py's LOGITS_ATOL 1e-4 against the JAX package
  (one logit of 32768 is 1.2e-5 off).
- The scan alone (S 12, B 3, H 2, D 16, a nonzero initial state):
  gradients of R, the gates and each initial-state part within atol
  1e-5 / rtol 1e-4 of jax.grad of the JAX scan and of autograd through
  ``recurrent._slstm_step``.
- bf16: the h carry stays bf16, as in the JAX scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params, np32
from repro.checkpoint.store import _flatten_with_paths
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.models.slstm_scan import slstm_scan as jax_slstm_scan
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro.train.steps import lm_loss as jax_lm_loss
from repro_torch.configs import concrete_batch, get_config
from repro_torch.models.params import params_to_numpy
from repro_torch.models.recurrent import _slstm_step
from repro_torch.models.slstm_scan import slstm_scan
from repro_torch.models.transformer import forward
from repro_torch.train.steps import _grads, lm_loss

BATCHED = {"slstm_batched_grad": True}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("xlstm-125m").reduced(num_layers=4)
    cfg = get_config("xlstm-125m").reduced(num_layers=4)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(0))
    return (jcfg, cfg, jparams, jax_to_torch_params(jparams),
            jax_concrete_batch(jcfg, 2, 32), concrete_batch(cfg, 2, 32,
                                                            device="cpu"))


def test_forward_matches(setup):
    jcfg, cfg, jparams, params, jbatch, batch = setup
    want, _ = jax_forward(jparams, jcfg, jbatch,
                          opts={"slstm_batched_grad": True})
    got, _ = forward(params, cfg, batch, opts=BATCHED)
    plain, _ = forward(params, cfg, batch, opts={})
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np32(got), np32(plain), atol=1e-5, rtol=1e-5)


def test_grads_match_jax_and_step_loop(setup):
    jcfg, cfg, jparams, params, jbatch, batch = setup
    jg = jax.grad(lambda p: jax_lm_loss(
        p, jcfg, jbatch, opts={"slstm_batched_grad": True})[0])(jparams)
    g, _ = _grads(lambda p, b: lm_loss(p, cfg, b, opts=BATCHED), params,
                  batch)
    g_loop, _ = _grads(lambda p, b: lm_loss(p, cfg, b), params, batch)
    want = _flatten_with_paths(jg)
    got, loop = params_to_numpy(g), params_to_numpy(g_loop)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-6, rtol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], loop[k], atol=5e-6, rtol=1e-3,
                                   err_msg=k)


S, B, H, D = 12, 3, 2, 16
GATES = ("rz", "ri", "rf", "ro")


def _inputs(seed):
    rng = np.random.RandomState(seed)
    f = lambda *shape, s=1.0: (rng.randn(*shape) * s).astype(np.float32)
    R = {k: f(H, D, D, s=0.3) for k in GATES}
    gates = f(S, B, H, D, 4)
    init = (f(B, H, D), np.abs(f(B, H, D)) + 0.5, f(B, H, D), f(B, H, D, s=0.5))
    # the cotangents: weights on the h sequence and on the final state
    w = (f(S, B, H, D), *(f(B, H, D) for _ in range(4)))
    return R, gates, init, w


def _loss(final, hs, w, lib):
    total = lib.sum(hs * w[0])
    for x, wx in zip(final, w[1:]):
        total = total + lib.sum(x * wx)
    return total


def _plain_scan(R, gates, init):
    carry, hs = init, []
    for t in range(gates.shape[0]):
        carry = _slstm_step(R, carry, gates[t])
        hs.append(carry[3])
    return carry, torch.stack(hs)


def _torch_grads(fn, R, gates, init, w):
    R = {k: torch.tensor(v, requires_grad=True) for k, v in R.items()}
    gates = torch.tensor(gates, requires_grad=True)
    init = tuple(torch.tensor(x, requires_grad=True) for x in init)
    final, hs = fn(R, gates, init)
    loss = _loss(final, hs, [torch.tensor(x) for x in w], torch)
    out = torch.autograd.grad(loss, [*R.values(), gates, *init])
    return [np32(x) for x in out], [np32(x) for x in (*final, hs)]


def test_scan_grads_match_jax_and_step_loop():
    R, gates, init, w = _inputs(0)
    jR = {k: jnp.asarray(v) for k, v in R.items()}

    def jloss(R_, gates_, init_):
        final, hs = jax_slstm_scan(R_, gates_, init_)
        return _loss(final, hs, [jnp.asarray(x) for x in w], jnp)

    jgr, jgg, jgi = jax.grad(jloss, argnums=(0, 1, 2))(
        jR, jnp.asarray(gates), tuple(jnp.asarray(x) for x in init))
    want = [np32(jgr[k]) for k in GATES] + [np32(jgg)] + \
        [np32(x) for x in jgi]
    got, out = _torch_grads(slstm_scan, R, gates, init, w)
    loop, loop_out = _torch_grads(_plain_scan, R, gates, init, w)
    names = list(GATES) + ["gates", "c0", "n0", "m0", "h0"]
    for name, a, b, c in zip(names, got, want, loop):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=1e-4, err_msg=name)
    jfinal, jhs = jax_slstm_scan(jR, jnp.asarray(gates),
                                 tuple(jnp.asarray(x) for x in init))
    for a, b, c in zip(out, [*map(np32, jfinal), np32(jhs)], loop_out):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(a, c, atol=1e-6, rtol=1e-5)


def test_scan_bf16_keeps_h_in_bf16():
    """Under bf16 the scan's h sequence and final h are bf16, equal to the
    step loop's within 2**-8, one bf16 rounding of an |h| below 1 (the
    scan runs the four products as one batched matmul; measured equal on
    the CPU), and every gradient comes back in its input's dtype."""
    R, gates, init, _ = _inputs(1)
    Rb = {k: torch.tensor(v).to(torch.bfloat16).requires_grad_(True)
          for k, v in R.items()}
    gb = torch.tensor(gates).to(torch.bfloat16).requires_grad_(True)
    ib = (*(torch.tensor(x) for x in init[:3]),
          torch.tensor(init[3]).to(torch.bfloat16))
    final, hs = slstm_scan(Rb, gb, ib)
    loop_final, loop_hs = _plain_scan(Rb, gb, ib)
    assert hs.dtype == final[3].dtype == torch.bfloat16
    assert final[0].dtype == torch.float32
    np.testing.assert_allclose(np32(hs), np32(loop_hs), atol=2.0 ** -8,
                               rtol=0)
    grads = torch.autograd.grad(hs.float().sum(), [*Rb.values(), gb])
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
