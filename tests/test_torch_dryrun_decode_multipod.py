"""Decode in the port's dry run at (pod 2, data 2, model 2): rank 0's
flops of one greedy step against the reference's loop-aware HLO
analysis (tests/_torch_dryrun.py) for reduced h2o-danube-3-4b,
olmoe-1b-7b, recurrentgemma-2b and stablelm-12b under the "heads" and
the "seq" cache policy.

At B 32 the batch is cut over ("pod", "data") and they agree within 5%.
Where the batch rule is None the port's rank keeps the weights cut over
data ("embed") where they lie and splits their dots' contraction
(``context.contract_for``).  At B 1 h2o-danube-3-4b's flops then agree
within 5% and the payload stays within 4x of the reference's; for
recurrentgemma-2b GSPMD also splits the RG-LRU gates' output columns
over an axis that the rules leave idle on this mesh (not at (data 2,
model 4)), so its ratio is asserted as measured.  At B 16 (it divides
over 16 ranks, not 32) ``cache_shardings`` still cuts the caches' rows
over the four ranks of ("pod", "data"): each rank projects every row,
attends for its rows and gathers them before the output projection
(ROADMAP C10), and GSPMD partitions the step otherwise, so the ratios
are asserted as measured."""
import pytest

from _torch_dryrun import (DECODE_ARCHS, FLOPS_REL, POLICIES, decode_combos,
                           port, reference_decode)

MESH = "2x2x2"
B32 = [(a, p, 32) for a in DECODE_ARCHS for p in POLICIES]
# port / reference flops where the batch rule is None, measured
# (torch 2.13.0+cpu, jax 0.9.0); 1.0: they agree within FLOPS_REL
RATIO = {("h2o-danube-3-4b", "heads", 16): 1.7200,
         ("h2o-danube-3-4b", "seq", 16): 1.7200,
         ("olmoe-1b-7b", "heads", 16): 0.6173,
         ("olmoe-1b-7b", "seq", 16): 0.6173,
         ("recurrentgemma-2b", "heads", 16): 1.6294,
         ("recurrentgemma-2b", "seq", 16): 1.6494,
         ("stablelm-12b", "heads", 16): 1.7200,
         ("stablelm-12b", "seq", 16): 1.7200,
         ("h2o-danube-3-4b", "heads", 1): 1.0,
         ("h2o-danube-3-4b", "seq", 1): 1.0,
         ("recurrentgemma-2b", "heads", 1): 1.1393,
         ("recurrentgemma-2b", "seq", 1): 1.1377}
B1 = [(a, p, b) for a, p, b in decode_combos() if b == 1]
# the port's payload at B 1 against the reference's
PAYLOAD_X = 4.0


@pytest.fixture(scope="module")
def ref():
    return reference_decode(MESH, decode_combos() + B32)


def test_the_departures_are_the_combinations_without_a_batch_cut():
    assert sorted(RATIO) == sorted(decode_combos())
    # at B 1 the dots of the weights agree; recurrentgemma-2b's RG-LRU
    # gates are what GSPMD splits beyond the rules
    assert {k for k, v in RATIO.items() if v != 1.0} == \
        {k for k in RATIO if k[2] == 16 or k[0] == "recurrentgemma-2b"}


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


@pytest.mark.parametrize("arch,policy,batch", B1)
def test_decode_payload_near_the_reference_at_one_row(ref, arch, policy,
                                                      batch):
    want = ref[f"{arch}|{policy}|{batch}"]["collectives"]["total"]
    got = port(arch, "decode", MESH, policy, batch)["collectives"]["total"]
    assert 0 < got <= PAYLOAD_X * want, got / want
