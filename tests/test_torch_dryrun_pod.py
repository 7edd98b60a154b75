"""The port's dry run (src/repro_torch/launch/dryrun.py) at (data 2,
model 4): rank 0's flops against the reference's loop-aware HLO analysis
(tests/_torch_dryrun.py) for train and prefill of reduced
h2o-danube-3-4b, olmoe-1b-7b, recurrentgemma-2b and xlstm-125m at B 16 x
S 64 (decode: tests/test_torch_dryrun_decode_*.py); and ``run_one``'s
records of a decode shape and of a shape it skips."""
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
    """Decode is traced now: the record of a decode shape is ``ok``, with
    the keys of a train or prefill record, and its argument bytes hold
    the rank's part of the decode state."""
    rec = dryrun.run_one("xlstm-125m", "decode_32k", False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mode"] == "decode" and rec["mesh"] == "pod_16x16"
    assert set(rec) == {"arch", "shape", "mesh", "mode", "preset",
                        "status", "trace_s", "params", "flops",
                        "bytes_written", "collectives", "memory", "wall_s"}
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    # B 128 over data 16: the rank's 8 rows of every state leaf, cut on
    # one feature dim over model 16 (launch.mesh.cache_shardings), fp32
    # but the bf16 conv tails; 6 layers of each kind
    cfg = dryrun.get_config("xlstm-125m")
    up, dh_m, dh_s = 2 * cfg.d_model, 2 * cfg.d_model // 4, cfg.d_model // 4
    mlstm = 8 * 4 * (dh_m * dh_m + dh_m) // 16 * 4 + 8 * 4 * 4 \
        + 8 * 3 * up // 16 * 2
    slstm = 4 * 8 * 4 * dh_s // 16 * 4 - 8 * 4 * dh_s // 16 * 2
    params = dryrun._nbytes(dryrun.build_lowerable(
        cfg, dryrun.INPUT_SHAPES["decode_32k"],
        dryrun.make_production_mesh(), False)[1][0])
    assert rec["memory"]["argument_bytes"] == \
        params + 8 * 4 + 6 * (mlstm + slstm) + 4


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
    assert all(r["status"] == "ok" and r["mode"] == "decode" for r in recs)
    assert "0 failures (2 ok)" in capsys.readouterr().out
