"""The port's continuous-batching engine: token-identical to the JAX
package's engine on staggered requests, equal to offline greedy
generation, and the same admission, rejection and clock rules."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params
from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_model as jax_init_model
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.transformer import forward, init_model
from repro_torch.serving.engine import ContinuousBatchingEngine, Request


def _offline(params, cfg, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        lg, _ = forward(params, cfg, {"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(lg[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("arch", ["gemma3-4b", "h2o-danube-3-4b"])
def test_engine_matches_jax_engine(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(0))
    params = jax_to_torch_params(jparams)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(3, 8)).tolist()
               for _ in range(4)]
    arrivals = [0.0, 0.5, 1.0, 1.5]   # staggered: admitted in this order
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
        assert r.output == expected[r.rid], (arch, r.rid)
        assert r.output == _offline(params, cfg, prompts[r.rid], 4)


def test_engine_accounting():
    cfg = get_config("gemma3-4b").reduced()
    params = init_model(cfg, seed=0, device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                   device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[1, 2, 3], max_new_tokens=5))
    done = eng.run()
    th = eng.throughput()
    assert th["requests"] == 3 and th["tokens"] == 15
    assert th["steps"] < 3 * (3 + 5 - 1)   # continuous, not sequential
    for r in done:
        assert r.ttft_s is not None and r.ttft_s <= r.done_s


def test_oversized_request_rejected():
    cfg = get_config("gemma3-4b").reduced()
    eng = ContinuousBatchingEngine(cfg, init_model(cfg, device="cpu"),
                                   slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[1] * 6, max_new_tokens=6))
    assert not eng.queue


def test_admission_order_and_clock():
    """Admission follows arrival_s (ties in submission order), slot reuse
    leaks nothing, and a second run() continues the engine clock."""
    cfg = get_config("gemma3-4b").reduced()
    eng = ContinuousBatchingEngine(cfg, init_model(cfg, seed=2, device="cpu"),
                                   slots=1, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=[5, 17, 42], max_new_tokens=3,
                       arrival_s=5.0))
    eng.submit(Request(rid=1, prompt=[3, 4], max_new_tokens=3,
                       arrival_s=1.0))
    eng.submit(Request(rid=2, prompt=[5, 17, 42], max_new_tokens=3,
                       arrival_s=1.0))
    assert [r.rid for r in eng.queue] == [1, 2, 0]
    done = eng.run()
    assert [r.rid for r in sorted(done, key=lambda r: r.done_s)] == [1, 2, 0]
    assert done[1].output == done[2].output   # same prompt, reused slot
    first_done = eng.finished[-1].done_s
    eng.submit(Request(rid=3, prompt=[3, 4], max_new_tokens=3))
    eng.run()
    assert eng.finished[-1].rid == 3
    assert eng.finished[-1].done_s > first_done
