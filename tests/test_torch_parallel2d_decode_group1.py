"""Decode under the dry run's rules plan in a world-size-1 gloo group, on
(data 1, model 1): each axis holds one rank, so every placement of the
decode state cuts nothing, no block takes a split path, and three greedy
steps are bit-equal (logits, tokens and every state leaf) to the
no-group ``decode_step`` from the same weights, state and tokens
(``tests/_torch_parallel2d_decode.decode_group_of_one``; one spawn), at
one position for every row and (``rows``) at each row's own.
And the next token over vocab-cut logits on two gloo ranks: ties break
to the lowest index, across the ranks' parts as within one, as
``jnp.argmax`` breaks them."""
import numpy as np
import pytest
import torch

from _torch_parallel2d_decode import (L, decode_group_of_one, greedy_parts,
                                      start_pos)
from test_torch_parallelism import SPAWN_TIMEOUT_S
from repro_torch.configs import get_config
from repro_torch.models.params import init_params, params_to_numpy
from repro_torch.models.transformer import model_spec
from repro_torch.parallelism.dist import spawn
from repro_torch.testing.parallel_check import (decode_case, main,
                                                random_decode_state)

# name -> (arch, policy, batch, rules over rules_plan's, per-row pos)
RUNS = {"h2o-heads-b8": ("h2o-danube-3-4b", "heads", 8, None, False),
        "h2o-seq-b1": ("h2o-danube-3-4b", "seq", 1, {"batch": None}, False),
        "rgemma-heads-b8": ("recurrentgemma-2b", "heads", 8, None, False),
        "xlstm-b8": ("xlstm-125m", "heads", 8, None, False),
        "h2o-seq-b8-rows": ("h2o-danube-3-4b", "seq", 8, None, True),
        "rgemma-heads-b8-rows": ("recurrentgemma-2b", "heads", 8, None,
                                 True)}


@pytest.fixture(scope="module")
def got():
    runs = []
    for name, (arch, policy, b, rules, per_row) in RUNS.items():
        cfg = get_config(arch).reduced(num_layers=4)
        params = params_to_numpy(init_params(model_spec(cfg), 3,
                                             device="cpu"))
        tokens = np.random.RandomState(b).randint(
            0, cfg.vocab_size, (b, 1)).astype(np.int32)
        runs.append((name, cfg, params, decode_case(
            policy, tokens, random_decode_state(cfg, b, L, seed=b),
            start_pos(b, per_row), L, rules)))
    return spawn(decode_group_of_one, ["cpu"], runs,
                 timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", list(RUNS))
def test_a_group_of_one_decodes_bit_equal_to_no_group(got, name):
    a, b = got[name]["no_group"], got[name]["group"]
    for (la, ta), (lb, tb) in zip(a["steps"], b["steps"]):
        assert np.array_equal(ta, tb) and np.array_equal(la, lb)
    assert set(a["state"]) == set(b["state"])
    for k in a["state"]:
        assert np.array_equal(a["state"][k], b["state"][k]), k


def test_greedy_tokens_over_vocab_parts_break_ties_to_the_lowest_index():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((6, 1, 16)).astype(np.float32)
    logits[1, 0, [3, 12]] = 9.0        # a tie across the two parts
    logits[2, 0, [9, 14]] = 9.0        # a tie inside the second part
    logits[3, 0, [0, 7]] = 9.0         # a tie inside the first part
    logits[4] = 1.0                    # every index ties
    got = spawn(greedy_parts, ["cpu"] * 2, logits,
                timeout_s=SPAWN_TIMEOUT_S)
    want = np.argmax(logits[:, -1], axis=-1)[:, None]
    assert list(want[1:5, 0]) == [3, 9, 0, 0]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_parallel_check_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """``parallel_check --decode`` without ``--device`` asks for the
    cards, and raises where there are none instead of running gloo
    ranks on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["h2o-danube-3-4b", "--mesh", "2x2", "--decode", "--per-row"])
