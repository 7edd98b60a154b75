"""A checkpoint that crosses the dry run's two small rules meshes on
h2o-danube-3-4b reduced to 4 layers: a full tree resumed on (data 2,
model 2), each rank cutting its part of every leaf (``BuiltJob.cut_array``
over two cut dims), one step, the full tree gathered onto rank 0
(``full_state``) and written, resumed on (pod 2, data 1, model 2), one
more step; against two straight JAX steps at tests/_torch_parallel2d.py's
bounds."""
import jax
import numpy as np

from _torch_parallel2d import checkpoint_cross
from _torch_port import np32
from test_torch_model import _rescale
from test_torch_parallelism import (OPT, PARAM_ATOL, RTOL, SPAWN_TIMEOUT_S,
                                    _batch, _cfgs, _close, _jstep)
from repro.checkpoint.store import _flatten_with_paths
from repro.models import transformer as jt
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.models.params import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.parallelism.dist import spawn


def test_a_checkpoint_crosses_the_two_meshes(tmp_path):
    arch = "h2o-danube-3-4b"
    jcfg, cfg = _cfgs(arch)
    jparams = _rescale(jcfg, jt.init_model(jcfg, jax.random.PRNGKey(1)))
    b1, b2 = _batch(jcfg, key=1), _batch(jcfg, key=2)
    jstep = _jstep(jcfg)
    jp1, jo1, _ = jstep(jparams, jax_init_opt_state(jparams), b1)
    jp2, _, jm2 = jstep(jp1, jo1, b2)
    params = params_from_numpy(_flatten_with_paths(jparams), device="cpu")
    init, mid = str(tmp_path / "init.npz"), str(tmp_path / "mid.npz")
    save_checkpoint(init, {"params": params,
                           "opt": init_opt_state(params)}, {"step": 0})
    m, start, p2 = spawn(checkpoint_cross, ["cpu"] * 4, cfg,
                         AdamWConfig(**OPT), init, mid, b1, b2,
                         timeout_s=SPAWN_TIMEOUT_S)
    assert start == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k], np32(jm2[k]), rtol=RTOL, err_msg=k)
    _close(p2, jp2, PARAM_ATOL, "params")
