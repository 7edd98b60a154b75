"""The port's dry run (src/repro_torch/launch/dryrun.py) at (data 2,
model 4): rank 0's flops against the reference's loop-aware HLO analysis
(tests/_torch_dryrun.py) for train and prefill of reduced
h2o-danube-3-4b, olmoe-1b-7b and recurrentgemma-2b at B 16 x S 64; and
``run_one``'s records for the shapes it does not trace."""
import json

import pytest

from _torch_dryrun import ARCHS, FLOPS_REL, MODES, port, reference
from repro_torch.launch import dryrun


@pytest.fixture(scope="module")
def ref():
    return reference("2x4")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_agree_with_the_reference(ref, arch, mode):
    want = ref[f"{arch}|{mode}"]["flops"]
    got = port(arch, mode, "2x4")["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), got / want


def test_decode_is_recorded_as_not_ported():
    rec = dryrun.run_one("xlstm-125m", "decode_32k", False, verbose=False)
    assert rec["status"] == "not_ported" and "A13b" in rec["reason"]
    assert rec["mode"] == "decode" and rec["mesh"] == "pod_16x16"


def test_long_context_of_a_full_attention_arch_is_skipped():
    rec = dryrun.run_one("stablelm-12b", "long_500k", True,
                         preset="optimized", verbose=False)
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("pure full-attention arch")


def test_main_writes_a_record_a_combination(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "gemma3-4b", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(tmp_path)])
    assert done.value.code == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert [r["mesh"] for r in recs] == ["multipod_2x16x16", "pod_16x16"]
    assert all(r["status"] == "not_ported" for r in recs)
    assert "0 failures (2 not_ported)" in capsys.readouterr().out
