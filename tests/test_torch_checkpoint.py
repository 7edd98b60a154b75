"""The port's checkpoint store (src/repro_torch/checkpoint/store.py)
against the JAX package's (src/repro/checkpoint/store.py): one format.

A checkpoint written by either package loads in the other, parameters
and optimizer state (float32 moments, an int32 step) alike, bit-equal;
the same arrays give the same content checksum in both; a bf16 leaf is
widened to float32 on save and cast back on load; corruption is
detected, and ``.prev`` rotation and fallback work as in the JAX
package.
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_to_torch_params
from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint import store
from repro_torch.models.params import params_to_numpy
from repro_torch.optim.adamw import init_opt_state

MICRO = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             name="xlstm-micro")


@pytest.fixture(scope="module")
def state():
    """The same training state in both packages: JAX init, opt state
    with nonzero moments and step 7."""
    jcfg = dataclasses.replace(jax_get_config("xlstm-125m").reduced(),
                               **MICRO)
    jparams = jt.init_model(jcfg, jax.random.PRNGKey(2))
    jopt = jax_init_opt_state(jparams)
    jopt = {"mu": jax.tree.map(lambda p: p * 0.5, jparams),
            "nu": jax.tree.map(lambda p: p * p, jparams),
            "step": jopt["step"] + 7}
    params = jax_to_torch_params(jparams)
    opt = {"mu": jax_to_torch_params(jopt["mu"]),
           "nu": jax_to_torch_params(jopt["nu"]),
           "step": torch.tensor(7, dtype=torch.int32)}
    return {"params": jparams, "opt": jopt}, {"params": params, "opt": opt}


def _equal(torch_tree, jax_tree):
    got, want = params_to_numpy(torch_tree), jstore._flatten_with_paths(
        jax_tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_checkpoint_loads_in_jax(state, tmp_path):
    jtree, ttree = state
    path = str(tmp_path / "port.npz")
    store.save_checkpoint(path, ttree, {"step": 7, "loss": 1.5})
    assert jstore.verify_checkpoint(path)["step"] == 7
    assert jstore.load_metadata(path) == {"step": 7, "loss": 1.5}
    loaded = jstore.load_checkpoint(path, jtree)
    assert loaded["opt"]["step"].dtype == jnp.int32
    _equal(ttree, loaded)
    params, opt, step = jstore.load_training_state(path, jtree["params"],
                                                   jtree["opt"])
    assert step == 7 and int(opt["step"]) == 7


def test_jax_checkpoint_loads_in_port(state, tmp_path):
    jtree, ttree = state
    path = str(tmp_path / "jax.npz")
    jstore.save_checkpoint(path, jtree, {"step": 7, "loss": 1.5})
    like = {"params": jax.tree.map(torch.zeros_like, ttree["params"]),
            "opt": init_opt_state(ttree["params"])}
    assert store.verify_checkpoint(path)["step"] == 7
    loaded = store.load_checkpoint(path, like)
    assert loaded["opt"]["step"].dtype == torch.int32
    _equal(loaded, jtree)
    params, opt, step = store.load_training_state(path, like["params"],
                                                  like["opt"])
    assert step == 7 and int(opt["step"]) == 7
    _equal({"params": params, "opt": opt}, jtree)


def test_same_arrays_same_checksum(state, tmp_path):
    jtree, ttree = state
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    store.save_checkpoint(a, ttree, {"step": 7})
    jstore.save_checkpoint(b, jtree, {"step": 7})
    assert store.verify_checkpoint(a)["checksum"] == \
        jstore.verify_checkpoint(b)["checksum"]
    assert store._content_checksum(params_to_numpy(ttree)) == \
        jstore._content_checksum(jstore._flatten_with_paths(jtree))


def test_bf16_leaves_widen_on_save_and_narrow_on_load(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"w": torch.tensor(rng.randn(3, 4), dtype=torch.bfloat16),
            "b": [torch.tensor(rng.randn(2), dtype=torch.float32)]}
    path = str(tmp_path / "bf16.npz")
    store.save_checkpoint(path, tree)
    with np.load(path) as data:
        assert data["w"].dtype == np.float32 and set(data) == {
            "w", "b/0", store.META_KEY}
    jloaded = jstore.load_checkpoint(
        path, {"w": jnp.zeros((3, 4), jnp.bfloat16),
               "b": [jnp.zeros(2, jnp.float32)]})
    loaded = store.load_checkpoint(path, tree)
    assert loaded["w"].dtype == torch.bfloat16
    assert torch.equal(loaded["w"], tree["w"])
    assert torch.equal(loaded["b"][0], tree["b"][0])
    np.testing.assert_array_equal(np.asarray(jloaded["w"], np.float32),
                                  tree["w"].float().numpy())


def _corrupt(path):
    """Flip bytes in the middle of the file (inside an array)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(16)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def test_corruption_detected_and_prev_fallback(state, tmp_path):
    _, ttree = state
    path = str(tmp_path / "ck.npz")
    store.save_checkpoint(path, ttree, {"step": 3})
    ttree2 = {"params": ttree["params"],
              "opt": dict(ttree["opt"], step=torch.tensor(
                  9, dtype=torch.int32))}
    store.save_checkpoint(path, ttree2, {"step": 9})
    assert store.verify_checkpoint(path + ".prev")["step"] == 3
    assert store.verify_checkpoint(path)["step"] == 9
    _corrupt(path)
    with pytest.raises(store.CheckpointCorruptError):
        store.verify_checkpoint(path)
    with pytest.raises(jstore.CheckpointCorruptError):
        jstore.verify_checkpoint(path)
    like_p = ttree["params"]
    like_o = init_opt_state(like_p)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, opt, step = store.load_training_state(path, like_p, like_o)
    assert step == 3 and int(opt["step"]) == 7
    msgs = " ".join(str(x.message) for x in w)
    assert "skipping corrupt checkpoint" in msgs and \
        "resumed from previous good checkpoint" in msgs
    _corrupt(path + ".prev")
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        p, o, step = store.load_training_state(path, like_p, like_o)
    assert step == 0 and p is like_p and o is like_o


def test_missing_file_and_missing_array(state, tmp_path):
    _, ttree = state
    p, o, step = store.load_training_state(str(tmp_path / "none.npz"),
                                           ttree["params"], ttree["opt"])
    assert step == 0 and p is ttree["params"]
    path = str(tmp_path / "part.npz")
    store.save_checkpoint(path, {"params": ttree["params"]})
    with pytest.raises(store.CheckpointCorruptError, match="missing array"):
        store.load_checkpoint(path, ttree)
    assert store.load_metadata(str(tmp_path / "none.npz")) is None
