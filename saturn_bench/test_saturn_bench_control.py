"""The control must come out not correct: the reference computed with
TF32 products (the precision below the configurations' float32), in the
program's place, against the reference in float32, at each cell's own
size on the card."""
import pytest

from saturn_bench import cells, check, drive

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", WORKLOADS)
def test_tf32_control_fails(name, cuda_device):
    cell = cells.load_cell(name)
    seed = 2 ** 31 + 101
    ring = drive.token_ring(seed, cell.traffic, cell.config["vocab_size"],
                            cuda_device)
    opt = dict(cell.traffic["optimizer"], lr=cell.traffic["lr"],
               total_steps=cell.traffic["total_steps"])
    ref = drive.reference(cell, opt, ring, seed, cuda_device)
    drive.free(cuda_device)
    ctrl = drive.reference(cell, opt, ring, seed, cuda_device, tf32=True)
    drive.free(cuda_device)
    values = check.numbers(ctrl, ref)
    assert not check.judge(values, cell.traffic["limits"]), values
