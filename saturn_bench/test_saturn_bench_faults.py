"""A run driven end to end on the CPU, past the look for a card: sound,
it is correct; with the timed path broken underneath, it is not."""
import pytest

from saturn_bench import faults, tiny

WORKLOAD = "olmoe-l4.train-s4096"


@pytest.mark.parametrize("kind", ["moe", "dense"])
@pytest.mark.parametrize("fault", [None] + list(faults.FAULTS))
def test_run_catches_fault(kind, fault):
    from saturn_bench import drive
    cell = tiny.cell(kind, WORKLOAD, batch=1 if fault == "half_batch"
                     and kind == "dense" else 2)
    result = drive.run_cell(cell, 2 ** 32 + 5, 0.05, device="cpu",
                            fault=fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in cell.end_to_end}
    assert set(result["metrics"]) == names - {"peak_mem_gib"}


def test_traced_run_reads_per_layer_metrics():
    from saturn_bench import drive
    cell = tiny.cell("moe", WORKLOAD)
    result = drive.run_cell(cell, 3, 0.05, trace=True, device="cpu")
    assert result["correct"]
    # no card: no device events, no card peak; every reader says nothing
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0
    assert result["breakdown"]["idle_gaps"]
