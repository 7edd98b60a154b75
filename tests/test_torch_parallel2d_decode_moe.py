"""Decode under the dry run's rules plans on olmoe-1b-7b reduced to 4
layers (4 experts cut over model): under the optimized preset's
overrides for decode (``launch.dryrun.optimized_overrides``: the "seq"
cache policy and the batch left whole) every rank runs every row while
the KV cache is cut by its rows and by sequence, so each rank attends
for its rows and the rows are gathered after attention; under the
baseline "heads" policy the cache is cut by kv heads.

The cases and bounds are tests/_torch_parallel2d_decode.py's."""
import pytest

from _torch_parallel2d_decode import DecodeRuns, check_state, check_steps
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import optimized_overrides
from repro_torch.models.config import INPUT_SHAPES

ARCH = "olmoe-1b-7b"
_OPT = optimized_overrides(get_config(ARCH), INPUT_SHAPES["decode_32k"])
CASES = {"heads-b8": ("heads", 8, None),
         "optimized-b8": (_OPT["cache_policy"], 8, _OPT["rules_override"]),
         "heads-b8-rows": ("heads", 8, None, True),
         "seq-b8-rows": ("seq", 8, None, True),
         "optimized-b8-rows": (_OPT["cache_policy"], 8,
                               _OPT["rules_override"], True)}
MESHES = ["2x2", "2x1x2"]


def test_the_optimized_preset_cuts_the_sequence_and_not_the_batch():
    assert _OPT["cache_policy"] == "seq"
    assert _OPT["rules_override"] == {"batch": None}


@pytest.fixture(scope="module")
def runs():
    return DecodeRuns(ARCH, CASES)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_steps_match_jax(runs, mesh, case):
    check_steps(runs(mesh, case))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rules_decode_state_parts_match_jax(runs, mesh, case):
    check_state(runs(mesh, case), cut=("/k", "/v"))
