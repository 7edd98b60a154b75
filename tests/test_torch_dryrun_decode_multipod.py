"""Decode in the port's dry run at (pod 2, data 2, model 2): rank 0's
flops of one greedy step against the reference's loop-aware HLO
analysis (tests/_torch_dryrun.py) for reduced h2o-danube-3-4b,
olmoe-1b-7b, recurrentgemma-2b and stablelm-12b under the "heads" and
the "seq" cache policy.

At B 32 the batch is cut over ("pod", "data") and they agree within 5%.
At B 16 the activations' batch rule is None (it divides over 16 ranks,
not 32) while ``cache_shardings`` still cuts the caches' rows over the
four ranks of ("pod", "data"): each rank attends for its rows and
gathers them after attention, and runs the weights' dots on every row
(ROADMAP C10); at B 1 the batch rule is None too (ROADMAP C12).  There
GSPMD splits the weights' dots, so the ratios are asserted as
measured."""
import pytest

from _torch_dryrun import (DECODE_ARCHS, FLOPS_REL, POLICIES, decode_combos,
                           port, reference_decode)

MESH = "2x2x2"
B32 = [(a, p, 32) for a in DECODE_ARCHS for p in POLICIES]
# port / reference flops where the batch rule is None, measured
# (torch 2.13.0+cpu, jax 0.9.0)
RATIO = {("h2o-danube-3-4b", "heads", 16): 2.4400,
         ("h2o-danube-3-4b", "seq", 16): 2.4400,
         ("olmoe-1b-7b", "heads", 16): 1.1963,
         ("olmoe-1b-7b", "seq", 16): 1.1963,
         ("recurrentgemma-2b", "heads", 16): 2.4387,
         ("recurrentgemma-2b", "seq", 16): 2.4486,
         ("stablelm-12b", "heads", 16): 2.4400,
         ("stablelm-12b", "seq", 16): 2.4400,
         ("h2o-danube-3-4b", "heads", 1): 1.9545,
         ("h2o-danube-3-4b", "seq", 1): 1.9770,
         ("recurrentgemma-2b", "heads", 1): 1.9922,
         ("recurrentgemma-2b", "seq", 1): 1.9923}


@pytest.fixture(scope="module")
def ref():
    return reference_decode(MESH, decode_combos() + B32)


def test_the_departures_are_the_combinations_without_a_batch_cut():
    assert sorted(RATIO) == sorted(decode_combos())


@pytest.mark.parametrize("arch,policy,batch", B32)
def test_decode_flops_agree_where_the_batch_is_cut(ref, arch, policy,
                                                   batch):
    want = ref[f"{arch}|{policy}|{batch}"]["flops"]
    got = port(arch, "decode", MESH, policy, batch)["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), got / want


@pytest.mark.parametrize("arch,policy,batch", sorted(RATIO))
def test_decode_flops_depart_where_the_batch_rule_is_none(ref, arch, policy,
                                                          batch):
    want = ref[f"{arch}|{policy}|{batch}"]["flops"]
    got = port(arch, "decode", MESH, policy, batch)["flops"]
    assert got / want == pytest.approx(RATIO[arch, policy, batch],
                                       rel=FLOPS_REL)
