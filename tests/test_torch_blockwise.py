"""``blockwise_attention`` (src/repro_torch/models/blockwise.py) visits
only the kv blocks a q block sees and masks only those that cross the
diagonal or the window's edge; its output and its q, k and v gradients
are bit for bit those of the loop over every block
(``_torch_all_blocks``), at equal and unequal chunks, without a window,
with one that drops leading kv blocks and with one that drops none, at
GQA and MHA head counts."""
import pytest
import torch

import _torch_port  # noqa: F401  (thread cap)
from _torch_all_blocks import all_blocks_attention, forward_backward
from repro_torch.models.blockwise import _kv_blocks, blockwise_attention

S, D = 2048, 16
# window -> whether some q block drops leading kv blocks, at every chunk
# pair below (S 2048): 700 drops; 1800 masks at its edge and drops none
WINDOWS = {0: False, 700: True, 1800: False}


def _qkv(h, kv, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((1, S, n, D), generator=g)
                 for n in (h, kv, kv))


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("chunks", [(512, 512), (256, 512), (512, 256)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_bit_equal_to_the_all_blocks_loop(chunks, window, heads):
    qc, kc = chunks
    blocks = [_kv_blocks(i * qc, (i + 1) * qc - 1, window, kc)
              for i in range(S // qc)]
    assert any(first > 0 for first, _, _, _ in blocks) == WINDOWS[window]
    if window:      # some block is masked at the window's edge
        assert any(lo > first for first, lo, _, _ in blocks)
    kw = dict(window=window, q_chunk=qc, kv_chunk=kc)
    got = forward_backward(lambda *a: blockwise_attention(*a, **kw),
                           *_qkv(*heads))
    want = forward_backward(lambda *a: all_blocks_attention(*a, **kw),
                            *_qkv(*heads))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name
