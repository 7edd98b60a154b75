"""The dry run's rules plans on olmoe-1b-7b reduced to 4 layers (4 experts
top-2): the experts cut over model (expert parallelism), the heads, kv
heads and vocab too, embed over data.

The cases and bounds are tests/_torch_parallel2d.py's."""
import pytest

from _torch_parallel2d import Runs, check_prefill, check_step

ARCHS = ["olmoe-1b-7b"]
MESHES = ["2x2", "2x1x2"]


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_step_matches_jax_one_device_step(runs, arch, mesh, remat):
    check_step(runs(arch, mesh), remat)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_prefill_parts_match_jax_prefill(runs, arch, mesh):
    check_prefill(runs(arch, mesh), mesh)
