"""The dry run's rules plans on h2o-danube-3-4b reduced to 4 layers (4
heads, 4 kv heads, sliding-window attention, a dense FFN): heads, kv
heads, ffn and vocab cut over model, embed over data.

The cases and bounds are tests/_torch_parallel2d.py's."""
import pytest

from _torch_parallel2d import Runs, check_prefill, check_step

ARCHS = ["h2o-danube-3-4b"]
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

