"""The port's decode-rate script (src/repro_torch/testing/decode_rate.py)
on the CPU at a reduced config: one JSON line per arch and position
kind, each with its blocks' seconds a step."""
import json

import _torch_port  # noqa: F401  (thread cap)
from repro_torch.testing import decode_rate


def test_decode_rate_prints_a_record_per_arch_and_position_kind(capsys):
    decode_rate.main(["--arch", "gemma3-4b", "xlstm-125m", "--device",
                      "cpu", "--reduced", "--batch", "2", "--length", "48",
                      "--blocks", "2", "--block-steps", "3"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["arch"], r["per_row"]) for r in recs] == [
        ("gemma3-4b-smoke", False), ("gemma3-4b-smoke", True),
        ("xlstm-125m-smoke", False), ("xlstm-125m-smoke", True)]
    for r in recs:
        assert len(r["step_s"]) == 2 and min(r["step_s"]) > 0
        assert min(r["step_s"]) <= r["median_step_s"] <= max(r["step_s"])
        assert r["tokens_per_s"] == 2 / r["median_step_s"]
        assert r["device"] == "cpu"
