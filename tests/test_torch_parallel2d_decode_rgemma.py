"""Decode under the dry run's rules plans on recurrentgemma-2b reduced to
4 layers (RG-LRU, RG-LRU, window-32 attention with one kv head, then
RG-LRU): the KV cache is cut by head_dim over model (its one kv head
does not divide), at B 1 also by sequence over data; the RG-LRU's h and
conv tail by their rnn channels, as the rules cut its weights.

The cases and bounds are tests/_torch_parallel2d_decode.py's."""
import pytest

from _torch_parallel2d_decode import DecodeRuns, check_state, check_steps

CASES = {"heads-b8": ("heads", 8, None),
         "heads-b1": ("heads", 1, {"batch": None}),
         "heads-b8-rows": ("heads", 8, None, True),
         "seq-b8-rows": ("seq", 8, None, True),
         "seq-b1-rows": ("seq", 1, {"batch": None}, True)}
MESHES = ["2x2", "2x1x2"]


@pytest.fixture(scope="module")
def runs():
    return DecodeRuns("recurrentgemma-2b", CASES)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_steps_match_jax(runs, mesh, case):
    check_steps(runs(mesh, case))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_state_parts_match_jax(runs, mesh, case):
    check_state(runs(mesh, case), cut=("/k", "/v", "/h", "/conv"))
