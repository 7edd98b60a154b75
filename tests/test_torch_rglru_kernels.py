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


def _segmented_scan(a, b, warps=4, steps=16):
    """The CUDA kernel's split of the scan, in plain PyTorch at fp32: S in
    segments of ``warps * steps`` (4 x 16 where rows are 16-byte
    aligned, 8 x 8 or 8 x 16 where they are not); in each, every warp
    folds its ``steps`` steps from h = 0 into (prod a, local h), the
    pairs are composed in order from the segment's carry-in
    (h <- P h + H, never dividing by P), and each warp re-runs its steps
    from its own h_in.  Steps past S are the identity (a, b) = (1, 0)."""
    a, b = a.float(), b.float()
    bsz, s, r = a.shape
    seg = warps * steps
    pad = -s % seg
    a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a = a.reshape(bsz, -1, warps, steps, r)
    b = b.reshape(bsz, -1, warps, steps, r)
    prod = torch.ones_like(a[:, :, :, 0])
    loc = torch.zeros_like(b[:, :, :, 0])
    for u in range(steps):
        loc = a[:, :, :, u] * loc + b[:, :, :, u]
        prod = prod * a[:, :, :, u]
    out = torch.empty_like(a)
    carry = torch.zeros(bsz, r)
    for sg in range(a.shape[1]):
        h_in = []
        for w in range(warps):
            h_in.append(carry)
            carry = prod[:, sg, w] * carry + loc[:, sg, w]
        h = torch.stack(h_in, dim=1)
        for u in range(steps):
            h = a[:, sg, :, u] * h + b[:, sg, :, u]
            out[:, sg, :, u] = h
    return out.reshape(bsz, -1, r)[:, :s]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,r,bs,br", [
    (256, 128, 128, 128),
    (512, 256, 256, 128),
    (128, 384, 64, 128),
])
def test_segmented_scan_matches_pallas(dtype, s, r, bs, br):
    """The kernel's split against the Pallas kernel in interpret mode, at
    the shapes and tolerances of tests/test_kernels.py (the inputs in the
    dtype, the split at fp32, cast back as the kernel writes h)."""
    jdt, tdt = _DT[dtype]
    a, b = _inputs(3, 2, s, r)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    expected = jax_rglru_scan(ja, jb, block_s=bs, block_r=br, interpret=True)
    out = _segmented_scan(ta, tb).to(tdt)
    np.testing.assert_allclose(np32(out), np32(expected), atol=_ATOL[dtype],
                               rtol=1e-2)


@pytest.mark.parametrize("s,r,warps,steps", [
    (1, 7, 8, 16), (37, 77, 8, 16), (200, 200, 8, 16), (300, 33, 8, 16),
    (1000, 64, 4, 16), (300, 2560, 4, 16), (200, 200, 4, 5),
])
def test_segmented_scan_takes_ragged_shapes(s, r, warps, steps):
    """Any S (one step, less than a segment, not a multiple of one) and
    any R, against the JAX oracle at the fp32 kernel tolerance."""
    a, b = _inputs(4, 2, s, r)
    out = _segmented_scan(torch.from_numpy(a), torch.from_numpy(b), warps,
                          steps)
    want = jax.jit(jax_ref.rglru_scan_ref)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np32(out), np32(want), atol=2e-5, rtol=1e-2)


def test_segmented_scan_survives_an_underflowing_product():
    """Channels whose a is 1e-3 for a stretch: a warp's product of 16
    steps is 1e-48, which underflows to 0 in fp32; h = P h_in + H never
    divides by it, so the split stays finite and equal to the sequential
    fp32 scan."""
    a, b = _inputs(5, 2, 512, 64)
    a[:, 100:300, :16] = 1e-3
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prods = torch.prod(ta[:, 128:144, :16], dim=1)
    assert bool((prods == 0).all())
    out = _segmented_scan(ta, tb)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(np32(out), np32(rglru_scan_plain(ta, tb)),
                               atol=2e-5, rtol=1e-4)
