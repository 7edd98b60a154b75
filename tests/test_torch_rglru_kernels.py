"""The port's RG-LRU scan on the CPU (its plain version) against the JAX
package's Pallas kernel run in interpret mode, at the shapes and
tolerances of tests/test_kernels.py, on the same numpy inputs; ragged
sequences and channel counts against the JAX oracle; and the model
layer's log-step scan against the JAX package's associative scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np32
from repro.kernels import ref as jax_ref
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.models.recurrent import rglru_scan_ref as jax_model_scan
from repro_torch.kernels import ref
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.models.recurrent import rglru_scan_ref as model_scan

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py, rtol 1e-2


def _inputs(seed, b, s, r):
    """a in (0.8, 1.0) and b ~ N(0, 0.1^2), as tests/test_kernels.py."""
    rng = np.random.RandomState(seed)
    a = (1 / (1 + np.exp(-rng.randn(b, s, r))) * 0.2 + 0.8).astype(np.float32)
    b_ = (rng.randn(b, s, r) * 0.1).astype(np.float32)
    return a, b_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,r,bs,br", [
    (256, 128, 128, 128),
    (512, 256, 256, 128),
    (128, 384, 64, 128),
])
def test_rglru_scan_matches_pallas(dtype, s, r, bs, br):
    jdt, tdt = _DT[dtype]
    a, b = _inputs(0, 2, s, r)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    expected = jax_rglru_scan(ja, jb, block_s=bs, block_r=br, interpret=True)
    oracle = jax.jit(jax_ref.rglru_scan_ref)(ja.astype(jnp.float32),
                                             jb.astype(jnp.float32))
    n0 = rglru_scan.launches
    out = rglru_scan(ta, tb)
    assert rglru_scan.launches == n0          # a CPU tensor: no launch
    assert out.dtype == tdt and out.shape == (2, s, r)
    for want in (expected, oracle):
        np.testing.assert_allclose(np32(out), np32(want),
                                   atol=_ATOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("s,r", [(200, 200), (37, 77)])
def test_rglru_scan_takes_ragged_shapes(s, r):
    """Any S and R (the Pallas kernel asserts S % min(256, S) == 0 and
    R % min(128, R) == 0; the CUDA kernel masks the ragged edge)."""
    a, b = _inputs(1, 3, s, r)
    out = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = jax.jit(jax_ref.rglru_scan_ref)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np32(out), np32(want), atol=2e-5, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_scan_matches_jax(dtype):
    """The model layer's scan computes in its inputs' dtype, as the JAX
    associative scan does; the two combine steps in other orders, so
    bf16 is held to the kernel tests' bf16 tolerance.  Over 512 steps
    of a = 0.8 the running product of a underflows (0.8^512 < 1e-49),
    which a cumprod/cumsum closed form would divide by."""
    jdt, tdt = _DT[dtype]
    a, b = _inputs(2, 2, 512, 64)
    a[:, :, :8] = 0.8                      # channels whose product underflows
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    out = model_scan(ta, tb)
    assert out.dtype == tdt
    assert bool(torch.isfinite(out.float()).all())
    np.testing.assert_allclose(np32(out), np32(jax.jit(jax_model_scan)(ja, jb)),
                               atol=_ATOL[dtype], rtol=1e-2)
    np.testing.assert_array_equal(np32(ref.rglru_scan_ref(ta, tb)),
                                  np32(out))
    # the plain kernel version is the same scan at fp32, cast back
    np.testing.assert_array_equal(
        np32(rglru_scan_plain(ta, tb)),
        np32(model_scan(ta.float(), tb.float()).to(tdt)))
