"""The model-FLOP count against a count by hand at a tiny size."""
import pytest

from saturn_bench import flops, tiny


def test_live_pairs():
    assert flops.live_pairs(4, 0) == 10
    assert flops.live_pairs(5, 2) == 1 + 2 * 4
    assert flops.live_pairs(4, 4) == 10
    assert flops.live_pairs(6, 3) == sum(min(i + 1, 3) for i in range(6))


def test_moe_step_by_hand():
    c = tiny.MOE     # d 64, H 4 of 16, Kv 2, 8 experts top-2 of 32, V 256
    seq, batch = 8, 3
    per_token = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64)   # wq, wk + wv, wo
    per_token += 2 * 64 * 8 + 2 * 3 * 2 * 64 * 32        # router, 2 experts
    per_token = 2 * per_token + 2 * 64 * 256             # 2 layers, unembed
    pairs = seq * (seq + 1) // 2
    attention = 2 * 4 * 4 * 16 * pairs                   # 2 layers, 4 H D
    assert flops.step_flops(c, batch, seq) == \
        3 * batch * (seq * per_token + attention)


def test_dense_window_by_hand():
    c = tiny.DENSE   # 3 swa layers, window 24, SwiGLU 96
    seq = 40
    per_token = 3 * (2 * (64 * 64 + 2 * 64 * 32 + 64 * 64)
                     + 3 * 2 * 64 * 96) + 2 * 64 * 256
    pairs = sum(min(i + 1, 24) for i in range(seq))
    assert flops.step_flops(c, 1, seq) == \
        3 * (seq * per_token + 3 * 4 * 4 * 16 * pairs)


@pytest.mark.parametrize("name,per_token", [("olmoe-1b-7b-l4", 2.43e9),
                                            ("h2o-danube-3-4b-l8", 8.92e9)])
def test_real_configs(name, per_token):
    from saturn_bench import cells
    c = cells.load_json(f"{cells.HERE}/configs/{name}.json")
    got = flops.step_flops(c, 1, 4096) / 4096
    assert abs(got - per_token) / per_token < 0.01
