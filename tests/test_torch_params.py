"""The port's configs, parameter specs and weight carrying against the
JAX package: same configs, same spec keys/shapes/init rules and
param_count, a lossless numpy round trip, and the same synthetic
batches."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params
from repro.checkpoint.store import _flatten_with_paths
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import concrete_batch as jax_concrete_batch
from repro.configs import get_config as jax_get_config
from repro.models.params import is_spec as jax_is_spec
from repro.models.params import param_count as jax_param_count
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import model_spec as jax_model_spec
from repro_torch.configs import ARCH_IDS, concrete_batch, get_config
from repro_torch.models.params import (param_count, params_from_numpy,
                                       params_to_numpy,
                                       tree_leaves_with_paths)
from repro_torch.models.transformer import init_model, model_spec


def _jax_spec_leaves(cfg):
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_model_spec(cfg),
                                                   is_leaf=jax_is_spec)
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): (s.shape, s.axes, s.init, s.scale)
            for path, s in flat}


def test_arch_ids_match():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_copy_matches(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_model_spec_matches(arch):
    """Every config's spec, the MoE ones' (L, E, d, f) expert leaves
    and their scale-0.1 router included."""
    cfg = get_config(arch)
    spec = model_spec(cfg)
    ours = {"/".join(p): (s.shape, s.axes, s.init, s.scale)
            for p, s in tree_leaves_with_paths(spec)}
    assert ours == _jax_spec_leaves(jax_get_config(arch))
    assert param_count(spec) == jax_param_count(
        jax_model_spec(jax_get_config(arch)))


def test_numpy_round_trip():
    cfg = jax_get_config("gemma3-4b").reduced(num_layers=10)
    flat = _flatten_with_paths(jax_init_model(cfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(flat, device="cpu")
    assert isinstance(params["groups"], list) and len(params["groups"]) == 2
    assert params["groups"][0]["pos0_swa"]["mixer"]["wq"].shape == \
        (1, 256, 4, 64)
    back = params_to_numpy(params)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    # bf16 on the way in, float32 on the way out (as the store does)
    half = params_to_numpy(params_from_numpy(flat, dtype=torch.bfloat16,
                                             device="cpu"))
    w = flat["groups/0/pos0_swa/mixer/wq"]
    np.testing.assert_allclose(half["groups/0/pos0_swa/mixer/wq"], w,
                               rtol=2 ** -8, atol=0)


def test_numpy_round_trip_recurrentgemma():
    """recurrentgemma-2b.reduced(): the RG-LRU leaves (gates, conv, lam)
    carry across and back bit for bit."""
    cfg = jax_get_config("recurrentgemma-2b").reduced()
    flat = _flatten_with_paths(jax_init_model(cfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(flat, device="cpu")
    mixer = params["groups"][0]["pos0_rglru"]["mixer"]
    r = cfg.resolved_d_rnn
    assert mixer["w_rec_gate"].shape == (1, r, r)
    assert mixer["conv"]["w"].shape == (1, cfg.conv_width, r)
    np.testing.assert_array_equal(mixer["lam"].numpy(), 4.0)
    back = params_to_numpy(params)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


def test_numpy_round_trip_moe():
    """olmoe-1b-7b.reduced(): the router and the (L, E, d, f) expert
    leaves, stacked under the scanned group, carry across and back bit
    for bit."""
    cfg = jax_get_config("olmoe-1b-7b").reduced()
    flat = _flatten_with_paths(jax_init_model(cfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(flat, device="cpu")
    ffn = params["groups"][0]["pos0_attn"]["ffn"]
    m, d, n = cfg.moe, cfg.d_model, cfg.num_layers
    assert ffn["router"].shape == (n, d, m.num_experts)
    assert ffn["wi_gate"].shape == (n, m.num_experts, d, m.d_ff_expert)
    assert ffn["wo"].shape == (n, m.num_experts, m.d_ff_expert, d)
    back = params_to_numpy(params)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


def test_init_follows_spec_rules():
    cfg = get_config("gemma3-4b").reduced()
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    c = init_model(cfg, seed=4, device="cpu")
    jflat = _flatten_with_paths(jax_init_model(
        jax_get_config("gemma3-4b").reduced(), jax.random.PRNGKey(0)))
    ours = params_to_numpy(a)
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in jflat.items()}
    for key in ours:
        np.testing.assert_array_equal(ours[key], params_to_numpy(b)[key])
    assert not np.array_equal(ours["embed"], params_to_numpy(c)["embed"])
    np.testing.assert_array_equal(ours["final_norm"], 1.0)
    # fan_in = shape[-2]: (d, heads, head_dim) projections use the heads
    wq = ours["groups/0/pos0_swa/mixer/wq"]
    assert abs(wq.std() * np.sqrt(wq.shape[-2]) - 1.0) < 0.05
    emb = ours["embed"]
    assert abs(emb.std() * np.sqrt(emb.shape[-2]) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ["gemma3-4b", "musicgen-medium",
                                  "internvl2-1b"])
def test_concrete_batch_matches(arch):
    ours = concrete_batch(get_config(arch), 2, 16, device="cpu")
    theirs = jax_concrete_batch(jax_get_config(arch), 2, 16)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]))
        if key != "embeds":
            assert ours[key].dtype == torch.int32


def test_carried_params_drive_the_port():
    """Weights carried from a JAX init load into the port's tree and run
    the port's forward."""
    from repro_torch.models.transformer import forward
    jcfg = jax_get_config("gemma3-4b").reduced()
    params = jax_to_torch_params(jax_init_model(jcfg, jax.random.PRNGKey(0)))
    cfg = get_config("gemma3-4b").reduced()
    logits, aux = forward(params, cfg,
                          concrete_batch(cfg, 1, 4, device="cpu"))
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
