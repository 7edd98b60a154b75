"""Decode under the dry run's rules plans on xlstm-125m reduced to 4
layers: the mLSTM's C cut on its value dim, n on its key dim, m on its
heads and the conv tail on the up channels; the sLSTM's c, n, m and h
on head_dim, while the rules cut its heads (at model 2 they divide), so
its pre-activations are re-laid.

The cases and bounds are tests/_torch_parallel2d_decode.py's."""
import pytest

from _torch_parallel2d_decode import DecodeRuns, check_state, check_steps

CASES = {"b8": ("heads", 8, None), "b1": ("heads", 1, {"batch": None}),
         "b8-rows": ("heads", 8, None, True),
         "b1-rows": ("seq", 1, {"batch": None}, True)}
MESHES = ["2x2", "2x1x2"]


@pytest.fixture(scope="module")
def runs():
    return DecodeRuns("xlstm-125m", CASES)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_steps_match_jax(runs, mesh, case):
    check_steps(runs(mesh, case))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_state_parts_match_jax(runs, mesh, case):
    check_state(runs(mesh, case),
                cut=("/C", "/n", "/m", "/conv", "/c", "/h"))
