"""The port's dry run at (pod 2, data 2, model 2), B 32 x S 64: the batch
is cut over ("pod", "data"), and rank 0's flops agree with the
reference's loop-aware HLO analysis (tests/_torch_dryrun.py) within 5%
for train and prefill of reduced h2o-danube-3-4b, olmoe-1b-7b,
recurrentgemma-2b and xlstm-125m.  tests/test_torch_dryrun_multipod.py
holds B 16."""
import pytest

from _torch_dryrun import ARCHS, FLOPS_REL, MODES, port, reference


@pytest.fixture(scope="module")
def ref():
    return reference("2x2x2-b32")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_agree_where_the_batch_is_cut(ref, arch, mode):
    want = ref[f"{arch}|{mode}"]["flops"]
    got = port(arch, mode, "2x2x2-b32")["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), got / want
