"""The port's mLSTM-chunk and sLSTM-step kernels on the CPU (their plain
versions) against the JAX package's Pallas kernels run in interpret
mode, at the shapes and tolerances of tests/test_kernels.py, on the same
numpy inputs; and the port's chunked mLSTM oracle, final state included,
against the JAX package's."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np32
from repro.kernels import ref as jax_ref
from repro.kernels.mlstm_chunk import mlstm_chunk as jax_mlstm_chunk
from repro.kernels.slstm_step import slstm_step_scan as jax_slstm_step
from repro.models.blockwise import mlstm_chunked as jax_mlstm_chunked
from repro.models.slstm_scan import slstm_scan as jax_slstm_scan
from repro_torch.kernels import ref
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.slstm_step import (MAX_HEAD_DIM, MMA_THREADS,
                                            R_REGISTERS, cluster_split,
                                            mma_cluster, slstm_step_scan)
from repro_torch.models.blockwise import mlstm_chunked

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py: fp32 atol 2e-3, bf16 5e-2, rtol 5e-2
_MLSTM_ATOL = {"float32": 2e-3, "bfloat16": 5e-2}


def _mlstm_inputs(seed, b, s, h, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    ip = rng.randn(b, s, h).astype(np.float32)
    fp = (rng.randn(b, s, h) * 2 + 2).astype(np.float32)
    return q, k, v, ip, fp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,d,chunk", [
    (256, 2, 64, 128),
    (512, 4, 128, 128),
    (256, 2, 64, 64),
])
def test_mlstm_chunk_matches_pallas(dtype, s, h, d, chunk):
    jdt, tdt = _DT[dtype]
    xs = _mlstm_inputs(0, 2, s, h, d)
    jx = [jnp.asarray(x, jdt) for x in xs]
    tx = [torch.from_numpy(x).to(tdt) for x in xs]
    expected = jax_mlstm_chunk(*jx, chunk=chunk, interpret=True)
    oracle = jax_ref.mlstm_ref(*(x.astype(jnp.float32) for x in jx))
    out = mlstm_chunk(*tx)
    assert out.dtype == tdt and out.shape == (2, s, h, d)
    for want in (expected, oracle):
        np.testing.assert_allclose(np32(out), np32(want),
                                   atol=_MLSTM_ATOL[dtype], rtol=5e-2)


@pytest.mark.parametrize("s", [200, 37])
def test_mlstm_chunk_takes_a_ragged_sequence(s):
    """The CUDA kernel masks a ragged last chunk; its plain version pads
    it with steps that neither write nor decay, and matches the
    quadratic oracle."""
    xs = _mlstm_inputs(1, 1, s, 2, 64)
    out = mlstm_chunk(*(torch.from_numpy(x) for x in xs))
    want = jax_ref.mlstm_ref(*(jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(np32(out), np32(want), atol=2e-3, rtol=5e-2)


def test_mlstm_oracles_match_jax():
    """The port's quadratic and chunked oracles, and the chunked form's
    final (C, n, m), against the JAX package's at fp32.  The quadratic
    form sums S decayed scores into its normaliser, which cancel where
    |n| is small, so summation order shows at up to 1.4e-3 relative
    (measured on the CPU); the chunked form sums at most 64 and is held
    at 1e-5."""
    xs = _mlstm_inputs(2, 2, 256, 2, 32)
    tx = [torch.from_numpy(x) for x in xs]
    jx = [jnp.asarray(x) for x in xs]
    np.testing.assert_allclose(np32(ref.mlstm_ref(*tx)),
                               np32(jax_ref.mlstm_ref(*jx)),
                               atol=1e-5, rtol=2e-3)
    h, (C, n, m) = mlstm_chunked(*tx, chunk=64, return_final=True)
    jh, (jC, jn, jm) = jax_mlstm_chunked(*jx, chunk=64, return_final=True)
    for ours, theirs in ((h, jh), (C, jC), (n, jn), (m, jm)):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(np32(ours), np32(theirs), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(np32(ref.mlstm_chunked_ref(*tx, chunk=64)),
                               np32(jh), atol=1e-5, rtol=1e-5)


def _slstm_inputs(seed, b, s, h, d):
    rng = np.random.RandomState(seed)
    gates = (rng.randn(b, s, h, d, 4) * 0.5).astype(np.float32)
    rs = [(rng.randn(h, d, d) * 0.05).astype(np.float32) for _ in range(4)]
    return gates, rs


@pytest.mark.parametrize("s,h,d,bs", [
    (256, 2, 128, 64),
    (128, 4, 64, 128),
    (256, 1, 256, 32),
])
def test_slstm_step_matches_pallas(s, h, d, bs):
    gates, rs = _slstm_inputs(3, 2, s, h, d)
    jg, jr = jnp.asarray(gates), [jnp.asarray(r) for r in rs]
    init = (jnp.zeros((2, h, d)), jnp.zeros((2, h, d)),
            jnp.full((2, h, d), -1e30), jnp.zeros((2, h, d)))
    _, hs = jax_slstm_scan(dict(zip(["rz", "ri", "rf", "ro"], jr)),
                           jnp.swapaxes(jg, 0, 1), init)
    expected = jax_slstm_step(jg, *jr, block_s=bs, interpret=True)
    out = slstm_step_scan(torch.from_numpy(gates),
                          *(torch.from_numpy(r) for r in rs))
    assert out.dtype == torch.float32 and out.shape == (2, s, h, d)
    # tests/test_kernels.py: fp32 atol 1e-5, rtol 1e-4
    for want in (jnp.swapaxes(hs, 0, 1), expected):
        np.testing.assert_allclose(np32(out), np32(want), atol=1e-5,
                                   rtol=1e-4)


def test_slstm_step_bf16_matches_pallas():
    """bf16 inputs: both carry the state in float32 and round only the
    output, so they differ by at most one bf16 step of |h| <= 1."""
    gates, rs = _slstm_inputs(4, 2, 128, 2, 64)
    jg = jnp.asarray(gates, jnp.bfloat16)
    jr = [jnp.asarray(r, jnp.bfloat16) for r in rs]
    expected = jax_slstm_step(jg, *jr, block_s=64, interpret=True)
    out = slstm_step_scan(torch.from_numpy(gates).bfloat16(),
                          *(torch.from_numpy(r).bfloat16() for r in rs))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out), np32(expected), atol=2 ** -8,
                               rtol=0)


_SLSTM_HEAD_DIMS = list(range(16, MAX_HEAD_DIM + 1, 16))


@pytest.mark.parametrize("d", _SLSTM_HEAD_DIMS)
def test_slstm_fp32_split_gives_every_unit_to_one_thread_group(d):
    """The fp32 kernel's map (CTA rank r, thread t = u P + p -> unit
    r U + u, over d chunks p, p + P, ...): each unit, and so its four
    gate rows, belongs to one CTA and one group of P lanes; the chunks
    cover D once; the slice of R fits the registers it is given, with the
    fewest CTAs that allow it."""
    sp = cluster_split(d)
    units = Counter(r * sp.units + t // sp.parts for r in range(sp.cluster)
                    for t in range(0, sp.threads, sp.parts))
    assert units == Counter(range(d))
    chunks = sorted(p + sp.parts * c for p in range(sp.parts)
                    for c in range(sp.chunks))
    assert chunks == list(range(sp.parts * sp.chunks))
    assert d <= 4 * len(chunks) < d + 4 * sp.parts
    assert sp.cluster in (1, 2, 4, 8) and sp.cluster <= sp.parts
    assert sp.units * sp.cluster == d and 32 % sp.parts == 0
    assert sp.threads % 32 == 0
    assert sp.threads <= (512 if sp.chunks <= 4 else 384)
    assert sp.r_registers <= R_REGISTERS
    assert sp.cluster == 1 or 4 * d * d > sp.cluster // 2 * R_REGISTERS
    assert 16 + 2 * 16 * sp.parts * sp.chunks <= 48 * 1024   # h buffers


@pytest.mark.parametrize("d", _SLSTM_HEAD_DIMS)
def test_slstm_bf16_split_gives_every_gate_row_to_one_lane(d):
    """The bf16 kernel's map (warp w of CTA r holds units 8 w + 4 t +
    g % 4 as rows g and g + 8 of tile t: z, f for g < 4, i, o for
    g >= 4): every one of the 4 D gate rows is held once, by one CTA;
    a CTA stays at MMA_THREADS threads or fewer, with the fewest CTAs
    that allow it, and its R fits the A-fragment registers."""
    c = mma_cluster(d)
    units, warps = d // c, -(-(d // c) // 8)
    rows = Counter()
    for rank in range(c):
        for w in range(warps):
            for tile in range(2):
                for g in range(8):
                    u = 8 * w + 4 * tile + g % 4
                    if u < units:
                        e = rank * units + u
                        rows["zi"[g // 4], e] += 1
                        rows["fo"[g // 4], e] += 1
    assert rows == Counter({(gate, e): 1 for gate in "zifo"
                            for e in range(d)})
    assert c in (1, 2, 4) and units * c == d
    assert 32 * warps <= MMA_THREADS
    assert c == 1 or 32 * -(-(d // (c // 2)) // 8) > MMA_THREADS
    assert 2 * 2 * -(-d // 32) * 4 <= 128          # A fragments a lane
    assert 16 + 2 * 16 * 2 * -(-d // 32) * 16 <= 48 * 1024   # h buffers


@pytest.mark.parametrize("d", [0, 8, 24, 100, 272])
def test_slstm_refuses_head_dims_the_kernels_do_not_take(d):
    with pytest.raises(ValueError, match="multiple of 16"):
        cluster_split(d)
    with pytest.raises(ValueError, match="multiple of 16"):
        mma_cluster(d)
