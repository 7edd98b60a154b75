"""The port's dry run at (pod 2, data 2, model 2): rank 0's flops against
the reference's loop-aware HLO analysis (tests/_torch_dryrun.py) for
train and prefill of reduced h2o-danube-3-4b, olmoe-1b-7b,
recurrentgemma-2b and xlstm-125m at S 64 (B 32, where the batch is cut
and they agree within 5%: tests/test_torch_dryrun_multipod_b32.py).

At B 16 they depart (ROADMAP C10): ``activation_rules`` cuts the
batch only when it divides over 32 ranks, so the rule is None and the
port's rank runs every row, twice its B 32 work exactly, while GSPMD
still splits the dots of the replicated batch (the reference's flops
count only ``dot``, so that is the op that differs).  The ratios are
asserted as measured."""
import pytest

from _torch_dryrun import ARCHS, FLOPS_REL, MODES, port, reference

# port / reference flops at B 16, measured (torch 2.13.0+cpu, jax 0.9.0)
B16_RATIO = {("h2o-danube-3-4b", "train"): 1.8242,
             ("h2o-danube-3-4b", "prefill"): 1.9091,
             ("olmoe-1b-7b", "train"): 1.5670,
             ("olmoe-1b-7b", "prefill"): 1.3009,
             ("recurrentgemma-2b", "train"): 1.9218,
             ("recurrentgemma-2b", "prefill"): 1.9768,
             ("xlstm-125m", "train"): 1.7128,
             ("xlstm-125m", "prefill"): 1.6876}


@pytest.fixture(scope="module")
def ref():
    return reference("2x2x2")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_depart_where_the_batch_rule_is_none(ref, arch, mode):
    want = ref[f"{arch}|{mode}"]["flops"]
    got = port(arch, mode, "2x2x2")["flops"]
    assert got / want == pytest.approx(B16_RATIO[arch, mode], rel=FLOPS_REL)
    # every row of the batch on every rank: twice the B 32 rank's work
    assert got == 2 * port(arch, mode, "2x2x2-b32")["flops"]
