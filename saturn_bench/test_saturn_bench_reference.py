"""The reference against the program at a reduced size on the CPU: the
same weights bit for bit, and the checked steps' numbers within the
real cells' limits, on both families and both techniques."""
import pytest
import torch

from saturn_bench import cells, check, drive, tiny
from saturn_bench.reference import params as ref_params

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("name", [c["name"]
                                  for c in cells.benchmark()["configs"]])
def test_leaves_as_the_program_lays_them_out(name):
    from repro_torch.models.params import tree_leaves_with_paths
    from repro_torch.models.transformer import model_spec
    config = cells.load_json(f"{cells.HERE}/configs/{name}.json")
    spec = model_spec(cells.model_config(config))
    mine = {p: (s, i) for p, s, i in ref_params.leaves(config)}
    theirs = {"/".join(p): (tuple(s.shape), s.init)
              for p, s in tree_leaves_with_paths(spec)}
    assert mine.keys() == theirs.keys()
    for p, (shape, init) in theirs.items():
        assert mine[p][0] == shape and (mine[p][1] == "ones") == \
            (init == "ones"), p


@pytest.mark.parametrize("kind,technique,seq,batch", [
    ("moe", "ddp", 64, 2), ("moe", "remat-offload", 48, 1),
    ("dense", "ddp", 40, 2), ("dense", "remat-offload", 64, 2)])
def test_program_against_reference(kind, technique, seq, batch):
    torch.manual_seed(0)
    cell = tiny.cell(kind, WORKLOADS[0], seq=seq, batch=batch,
                     technique=technique)
    dev = torch.device("cpu")
    seed = 2 ** 31 + 11
    built, params, state, _, ring, opt, prog = drive.start(cell, seed, dev)
    del built, params, state
    values = check.numbers(prog, drive.reference(cell, opt, ring, seed, dev))
    assert check.judge(values, cell.traffic["limits"]), values


def test_blockwise_attention_against_reference():
    """At S 2048 the program's attention runs blockwise, as on the card
    at S 4096."""
    cell = tiny.cell("dense", WORKLOADS[-1], seq=2048, batch=1,
                     technique="remat-offload")
    cell.config.update(num_layers=1, d_model=32, num_heads=2,
                       num_kv_heads=1, head_dim=16, d_ff=32, window_size=1500)
    dev = torch.device("cpu")
    built, params, state, _, ring, opt, prog = drive.start(cell, 7, dev)
    del built, params, state
    values = check.numbers(prog, drive.reference(cell, opt, ring, 7, dev))
    assert check.judge(values, cell.traffic["limits"]), values
