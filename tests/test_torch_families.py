"""Forward and one-train-step parity with the JAX package for every
reduced config of the dense attention and RecurrentGemma families:
stablelm-12b (head dim 64 reduced from 160), internlm2-20b, internvl2-1b
(a vision-embeds prefix that the loss skips), musicgen-medium (audio
embeds in, codec labels, an untied unembed), gemma3-4b,
h2o-danube-3-4b and recurrentgemma-2b (the last three are also held in
other files, at other shapes).  The MoE configs are held in
tests/test_torch_moe.py, xLSTM's in tests/test_torch_train.py.

The shapes are tests/test_archs_smoke.py's: B 2 x S 16, the forward on
``concrete_batch`` and the step on the first ``SyntheticLM`` batch.  The
weights are the JAX init with wq, wk and wv rescaled to a fan-in of
d_model (tests/test_torch_model.py says why), the tolerances those of
tests/test_torch_model.py (logits) and tests/test_torch_train.py
(the step, gemma3-4b's).
"""
import jax
import numpy as np
import pytest

from _torch_port import jax_to_torch_params, np32
from test_torch_model import _rescale
from test_torch_train import OPT, _compare_trees
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as jt
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import concrete_batch, get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.transformer import forward
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.steps import make_train_step

ARCHS = ["stablelm-12b", "internlm2-20b", "internvl2-1b", "musicgen-medium",
         "gemma3-4b", "h2o-danube-3-4b", "recurrentgemma-2b"]
LOGITS_ATOL = 1e-4
PARAM_ATOL = 5e-4


def _setup(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = _rescale(jcfg, jt.init_model(jcfg, jax.random.PRNGKey(1)))
    return jcfg, cfg, jparams, jax_to_torch_params(jparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    jbatch = jax_concrete_batch(jcfg, 2, 16)
    batch = concrete_batch(cfg, 2, 16, device="cpu")
    assert batch.keys() == jbatch.keys()
    j_logits, _ = jax.jit(lambda p, b: jt.forward(p, jcfg, b))(jparams,
                                                                jbatch)
    logits, aux = forward(params, cfg, batch)
    assert logits.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(np32(logits), np32(j_logits),
                               atol=LOGITS_ATOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    jbatch = next(JaxSyntheticLM(jcfg, seed=0).batches(2, 16))
    batch = next(SyntheticLM(cfg, seed=0).batches(2, 16, device="cpu"))
    if cfg.frontend == "vision":       # the loss skips the patch prefix
        assert batch["embeds"].shape[1] + batch["tokens"].shape[1] == 16
    if cfg.frontend == "audio":        # codec labels, no tokens
        assert "tokens" not in batch and batch["labels"].shape == (2, 16)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**OPT)))
    jp, jo, jm = jstep(jparams, jax_init_opt_state(jparams), jbatch)
    p, o, m = make_train_step(cfg, AdamWConfig(**OPT))(
        params, init_opt_state(params), batch)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np32(m[k]), np32(jm[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert int(o["step"]) == int(jo["step"]) == 1
    _compare_trees(p, jp, PARAM_ATOL, "params")
    _compare_trees({"mu": o["mu"], "nu": o["nu"]},
                   {"mu": jo["mu"], "nu": jo["nu"]}, PARAM_ATOL, "opt")
    if not cfg.tie_embeddings:         # the untied unembed is trained
        assert float(o["mu"]["unembed"].abs().max()) > 0.0
