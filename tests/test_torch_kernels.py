"""The port's flash attention on the CPU (its plain version) against the
JAX package's Pallas kernel run in interpret mode, at the shapes and
tolerances of tests/test_kernels.py, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np32
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.blockwise import blockwise_attention as jax_blockwise
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 supports_head_dim)
from repro_torch.models.config import ATTN, SWA
from repro_torch.models.blockwise import blockwise_attention

_DT = {"float32": (jnp.float32, torch.float32, 2e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, s, h, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, s, kv, d).astype(np.float32)
    v = rng.randn(b, s, kv, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,d,window,bq,bk", [
    (256, 4, 4, 64, 0, 128, 128),     # MHA
    (256, 4, 2, 64, 0, 128, 64),      # GQA
    (512, 8, 1, 32, 0, 128, 128),     # MQA
    (256, 4, 2, 64, 100, 64, 64),     # sliding window
    (384, 2, 2, 128, 128, 128, 128),  # window == block
    (256, 4, 4, 128, 0, 128, 128),    # olmoe-1b-7b's heads: D 128, H = Kv
    (256, 14, 2, 64, 0, 128, 128),    # internvl2-1b's heads: D 64, 7:1 GQA
    (512, 4, 2, 128, 128, 128, 64),   # D 128, window == a 128-key tile
    (384, 4, 4, 128, 192, 128, 128),  # D 128, a window cutting a tile
])
def test_flash_attention_matches_pallas(dtype, s, h, kv, d, window, bq, bk):
    jdt, tdt, tol = _DT[dtype]
    q, k, v = _qkv(0, 2, s, h, kv, d)
    expected = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                         window=window, block_q=bq, block_k=bk,
                         interpret=True)
    out = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          window)
    assert out.dtype == tdt and out.shape == (2, s, h, d)
    np.testing.assert_allclose(np32(out), np32(expected), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [0, 64])
def test_attention_ref_and_blockwise_match_jax(window):
    """The plain oracles: naive attention and the S >= 2048 blockwise
    path, against the JAX package's, at fp32."""
    q, k, v = _qkv(1, 2, 256, 4, 2, 32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(np32(ref.attention_ref(tq, tk, tv, window)),
                               np32(jax_ref.attention_ref(jq, jk, jv, window)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        np32(blockwise_attention(tq, tk, tv, window=window, q_chunk=64,
                                 kv_chunk=64)),
        np32(jax_blockwise(jq, jk, jv, window=window, q_chunk=64,
                           kv_chunk=64)),
        atol=2e-5, rtol=2e-5)


def test_plain_version_takes_a_ragged_sequence():
    """The CUDA kernel masks a ragged last tile itself; its plain version
    (what the CPU runs) takes any S, matching the naive oracle."""
    q, k, v = _qkv(2, 1, 200, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(
        np32(flash_attention(tq, tk, tv, 50)),
        np32(jax_ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)), 50)),
        atol=2e-5, rtol=2e-5)


_ATTENTION_ARCHS = [a for a in ARCH_IDS
                    if {ATTN, SWA} & set(get_config(a).layer_types())]


@pytest.mark.parametrize("arch", _ATTENTION_ARCHS)
def test_every_attention_config_has_a_head_dim_the_kernel_takes(arch):
    """kernel_opts("cuda") routes every config's full-sequence attention
    through the CUDA kernel, so its head-dim check must pass each one."""
    assert supports_head_dim(get_config(arch).resolved_head_dim)


def test_head_dims_the_kernel_does_not_take_are_refused():
    """Multiples of 8 from 32 to 256 (TMA rows of whole 16-byte units,
    wgmma's widest n); anything else is refused."""
    taken = [d for d in range(0, 300) if supports_head_dim(d)]
    assert taken == list(range(32, 257, 8))
    for d in (0, 8, 16, 24, 100, 124, 257, 264, 512):
        assert not supports_head_dim(d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,d,window,bq,bk", [
    (256, 4, 2, 120, 0, 128, 128),    # h2o-danube-3-4b's head dim
    (256, 8, 2, 160, 100, 64, 64),    # stablelm-12b's head dim, a window
])
def test_padded_head_dims_match_pallas(dtype, s, h, kv, d, window, bq, bk):
    """The head dims the CUDA kernels pad (120 to 128, 160 to 192): the
    plain version against the Pallas kernel in interpret mode, at the
    tolerances of tests/test_kernels.py."""
    jdt, tdt, tol = _DT[dtype]
    q, k, v = _qkv(3, 2, s, h, kv, d)
    expected = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                         window=window, block_q=bq, block_k=bk,
                         interpret=True)
    out = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          window)
    assert out.dtype == tdt and out.shape == (2, s, h, d)
    np.testing.assert_allclose(np32(out), np32(expected), atol=tol, rtol=tol)
