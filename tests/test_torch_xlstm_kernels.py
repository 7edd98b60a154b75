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
import torch.nn.functional as F

from _torch_port import np32
from repro.kernels import ref as jax_ref
from repro.kernels.mlstm_chunk import mlstm_chunk as jax_mlstm_chunk
from repro.kernels.slstm_step import slstm_step_scan as jax_slstm_step
from repro.models.blockwise import mlstm_chunked as jax_mlstm_chunked
from repro.models.slstm_scan import slstm_scan as jax_slstm_scan
from repro_torch.kernels import ref
from repro_torch.kernels.mlstm_chunk import CHUNK, mlstm_chunk
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


@pytest.fixture
def one_torch_thread():
    """PyTorch's CPU ops on one thread for the test, restored after.  In
    a process that has run JAX ops, one of PyTorch's OpenMP worker threads
    now and then computes exp differently from the main thread, over that
    worker's whole range of the decay matrix, while every other range
    agrees bit for bit; whether and which worker varies from process to
    process.  The quadratic oracle's normaliser amplifies that past
    rtol 2e-3: tests/probe_mlstm_oracle_threads.py counts it in 3 of 40
    processes on 8 threads under load, and in none of 40 on one thread,
    where the work stays on the main thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mlstm_oracles_match_jax(one_torch_thread):
    """The port's quadratic and chunked oracles, and the chunked form's
    final (C, n, m), against the JAX package's at fp32.  The quadratic
    form sums S decayed scores into its normaliser, which cancel where
    |n| is small, so summation order shows at up to 1.4e-3 relative
    (measured on the CPU); the chunked form sums at most 64 and is held
    at 1e-5.  The port's side runs on one thread (``one_torch_thread``),
    so that its rounding does not depend on the machine's load."""
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


def _bf(x):
    return x.to(torch.bfloat16).float()


def _mlstm_kernel_model(q, k, v, i_pre, f_pre, *, value_tile, bf16,
                        slab=32, chunk=CHUNK, split_wv=True):
    """The bf16 CUDA kernel's split of the chunkwise mLSTM, in plain
    PyTorch at fp32.  Each value tile of ``value_tile`` columns carries
    its own slice of C (with its own n and m).  Per chunk: the gate
    statistics, with the intra-chunk stabiliser as a prefix max of
    i_j - cum_j; the scores, q C and q n summed slab by slab over the head
    dim, each slab's rows of C and n updated after q C has read them.
    With ``bf16`` the kernel's roundings: the copy of the old C that q C
    reads, the decayed scores P and the C update's w v go in as bf16
    hi + lo; n, q n and the row sums stay fp32 (``split_wv=False``
    rounds w v to bf16 once instead, as the kernel's first version did).
    A ragged S is padded with steps that neither write nor decay."""
    b, s, h, d = q.shape
    pad = -s % chunk
    seq = lambda x, value=0.0: F.pad(x.float(), (0, 0) * (x.ndim - 2)
                                     + (0, pad), value=value)
    q, k, v = (seq(x).permute(0, 2, 1, 3) for x in (q, k, v))   # B,H,S,D
    it_all = seq(i_pre, float("-inf")).permute(0, 2, 1)          # B,H,S
    lf_all = F.logsigmoid(seq(f_pre, float("inf"))).permute(0, 2, 1)
    split = ((lambda x: (_bf(x), _bf(x - _bf(x)))) if bf16
             else (lambda x: (x, torch.zeros_like(x))))
    wv = (lambda x: sum(split(x))) if split_wv or not bf16 else _bf
    scale = d ** -0.5
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    out = torch.empty_like(v)
    for v0 in range(0, d, value_tile):
        vt = slice(v0, v0 + value_tile)
        C = torch.zeros(b, h, d, value_tile)
        n = torch.zeros(b, h, d)
        m = torch.full((b, h), -1e30)
        for c0 in range(0, s + pad, chunk):
            ct = slice(c0, c0 + chunk)
            qc, kc, vc = q[:, :, ct], k[:, :, ct], v[:, :, ct, vt]
            it, lf = it_all[:, :, ct], lf_all[:, :, ct]
            cum = torch.cumsum(lf, -1)
            g = cum[..., -1:]
            m_intra = cum + torch.cummax(it - cum, -1).values
            m_inter = cum + m[..., None]
            mi = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)
            iw = torch.exp(m_inter - mi)
            m_next = torch.maximum(g[..., 0] + m, (it + g - cum).amax(-1))
            decay = torch.exp(g[..., 0] + m - m_next)[..., None]
            w = torch.exp(it + g - cum - m_next[..., None])
            scores = torch.zeros(b, h, chunk, chunk)
            hq = torch.zeros(b, h, chunk, value_tile)
            qn = torch.zeros(b, h, chunk)
            n_next = torch.empty_like(n)
            for d0 in range(0, d, slab):
                ds = slice(d0, d0 + slab)
                qs, ks = qc[..., ds], kc[..., ds]
                scores = scores + qs @ ks.transpose(-1, -2)
                hi, lo = split(C[:, :, ds])
                hq = hq + qs @ hi + qs @ lo
                qn = qn + (qs * n[:, :, None, ds]).sum(-1)
                n_next[:, :, ds] = decay * n[:, :, ds] + (w[..., None]
                                                          * ks).sum(-2)
                C[:, :, ds] = decay[..., None] * C[:, :, ds] + \
                    ks.transpose(-1, -2) @ wv(w[..., None] * vc)
            logd = cum[..., :, None] - cum[..., None, :] + it[..., None, :]
            p = torch.where(tri, scores * scale *
                            torch.exp(logd - mi[..., None]), 0.0)
            p_hi, p_lo = split(p)
            n_total = p.sum(-1) + qn * scale * iw
            den = torch.maximum(n_total.abs(), torch.exp(-mi))
            out[:, :, ct, vt] = (p_hi @ vc + p_lo @ vc + hq * scale *
                                 iw[..., None]) / den[..., None]
            n, m = n_next, m_next
    return out.permute(0, 2, 1, 3)[:, :s]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,d,chunk", [
    (256, 2, 64, 128),
    (512, 4, 128, 128),
    (256, 2, 64, 64),
])
def test_mlstm_kernel_model_matches_pallas(dtype, s, h, d, chunk):
    """The bf16 kernel's split (with its roundings for bf16 inputs)
    against the Pallas kernel in interpret mode, at the shapes and
    tolerances of tests/test_kernels.py, with the value tile the kernel
    takes at that D (64: 8 warps)."""
    jdt, tdt = _DT[dtype]
    xs = _mlstm_inputs(0, 2, s, h, d)
    jx = [jnp.asarray(x, jdt) for x in xs]
    tx = [torch.from_numpy(x).to(tdt) for x in xs]
    expected = jax_mlstm_chunk(*jx, chunk=chunk, interpret=True)
    out = _mlstm_kernel_model(*tx, value_tile=64,
                              bf16=dtype == "bfloat16").to(tdt)
    np.testing.assert_allclose(np32(out), np32(expected),
                               atol=_MLSTM_ATOL[dtype], rtol=5e-2)


@pytest.mark.parametrize("s,d,value_tile", [
    (37, 96, 96), (200, 96, 32), (200, 160, 32), (70, 192, 96),
])
def test_mlstm_kernel_model_takes_ragged_s_and_every_tile(s, d, value_tile):
    """Ragged S (a masked last chunk) and the value tiles the kernel
    takes (96 columns where D is a multiple of 96, else 64 or 32),
    against the quadratic oracle: at fp32 within the fp32 kernel
    tolerance, and with the bf16 roundings within the bf16 one."""
    xs = _mlstm_inputs(6, 2, s, 2, d)
    tx = [torch.from_numpy(x) for x in xs]
    want = np32(jax_ref.mlstm_ref(*(jnp.asarray(x) for x in xs)))
    exact = _mlstm_kernel_model(*tx, value_tile=value_tile, bf16=False)
    np.testing.assert_allclose(np32(exact), want, atol=2e-3, rtol=5e-2)
    rounded = _mlstm_kernel_model(*(x.bfloat16() for x in tx),
                                  value_tile=value_tile, bf16=True)
    want16 = np32(jax_ref.mlstm_ref(*(jnp.asarray(x, jnp.bfloat16)
                                      .astype(jnp.float32) for x in xs)))
    np.testing.assert_allclose(np32(rounded.bfloat16()), want16, atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("d", [96, 192])
def test_mlstm_kernel_model_holds_at_the_models_scale(d):
    """q, k and v ten times unit scale, as xlstm-125m's own activations
    are at random init (|q| up to ~27): the bf16 roundings of the split
    stay within the bf16 tolerance of the plain version.  With w v rounded
    to bf16 once instead of split into hi + lo, the same inputs land
    outside it: the failure the split repairs."""
    xs = [torch.from_numpy(x) for x in _mlstm_inputs(1, 1, 512, 2, d)]
    xs = [x * 10 for x in xs[:3]] + xs[3:]
    xs = [x.bfloat16() for x in xs]
    ref = np32(mlstm_chunk(*xs))
    out = _mlstm_kernel_model(*xs, value_tile=96, bf16=True).bfloat16()
    np.testing.assert_allclose(np32(out), ref, atol=5e-2, rtol=5e-2)
    once = np32(_mlstm_kernel_model(*xs, value_tile=96, bf16=True,
                                    split_wv=False).bfloat16())
    assert np.max(np.abs(once - ref) / (5e-2 + 5e-2 * np.abs(ref))) > 1
