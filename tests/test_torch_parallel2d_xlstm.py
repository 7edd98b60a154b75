"""The dry run's rules plans on xlstm-125m reduced to 4 layers: the
mLSTM's up-projection channels and heads and the sLSTM's heads cut over
model.  A prefill returns each rank's heads of the recurrent states and
its channels of the conv tails.

The cases and bounds are tests/_torch_parallel2d.py's."""
import pytest

from _torch_parallel2d import Runs, check_prefill, check_step

ARCHS = ["xlstm-125m"]
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
