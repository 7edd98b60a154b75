"""The dry run's rules plans on recurrentgemma-2b reduced to 4 layers:
the RG-LRU's rnn channels and the FFN's columns cut over model, its one
kv head whole, so the kv projection of the window-attention layers is
replicated.  A prefill returns each rank's channels of the RG-LRU's
states and the whole kv cache.

The cases and bounds are tests/_torch_parallel2d.py's."""
import pytest

from _torch_parallel2d import Runs, check_prefill, check_step

ARCHS = ["recurrentgemma-2b"]
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
