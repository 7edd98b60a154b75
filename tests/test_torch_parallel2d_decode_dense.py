"""Decode under the dry run's rules plans on h2o-danube-3-4b reduced to 4
layers (4 heads, 4 kv heads, window 32): under the "heads" policy the KV
cache is cut by kv heads over model, as the rules cut wq, wk and wv;
under "seq" by sequence over model (the write at pos 41 lands on model
rank 1, the window spans both), and at B 1 over (data, model), the
rules leaving the batch whole.

The cases and bounds are tests/_torch_parallel2d_decode.py's."""
import pytest

from _torch_parallel2d_decode import DecodeRuns, check_state, check_steps

CASES = {"heads-b8": ("heads", 8, None), "seq-b8": ("seq", 8, None),
         "heads-b1": ("heads", 1, {"batch": None}),
         "seq-b1": ("seq", 1, {"batch": None})}
MESHES = ["2x2", "2x1x2"]


@pytest.fixture(scope="module")
def runs():
    return DecodeRuns("h2o-danube-3-4b", CASES)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_steps_match_jax(runs, mesh, case):
    check_steps(runs(mesh, case))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_state_parts_match_jax(runs, mesh, case):
    check_state(runs(mesh, case), cut=("/k", "/v"))
