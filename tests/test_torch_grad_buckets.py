"""The gradient all-reduce of the port's data-parallel steps
(``collectives.all_reduce_buckets``, ROADMAP C9): sums in place, a
bucket of at most ``BUCKET_BYTES`` at a time, and so ``ddp`` at g > 1
holds about one bucket more than at g = 1 (it held a flat copy of the
gradients and a landing copy of each, two gradient trees more).

- the peak of ``analyze_train_step`` (meta tensors, a fake group) of
  reduced gemma3-4b at ddp x2 and x4, B 8 x S 32, is at most one bucket
  and 1% above x1: at the default bucket, which holds this model's whole
  gradient, and at 64 KiB, a few hundredths of it;
- on two gloo ranks the sums land in place, in each tensor's own
  layout, across dtypes, bucket edges and a tensor larger than a bucket;
- in a world-size-1 group, a ddp step and a rules plan's step on (data
  1, model 1) equal the no-group step bit for bit.
"""
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (thread cap)
from repro_torch.configs import concrete_batch, get_config
from repro_torch.launch.step_analysis import analyze_train_step
from repro_torch.models.params import param_count, params_to_numpy
from repro_torch.models.transformer import model_spec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallelism import collectives as C
from repro_torch.parallelism.build import BuiltJob
from repro_torch.parallelism.dist import spawn
from repro_torch.parallelism.techniques import DDP
from repro_torch.testing.parallel_check import rules_plan

SMALL_BUCKET = 64 * 1024


_PEAKS = {}


def _peak(cfg, g, bucket):
    """The analyzer's peak bytes of a ddp x``g`` step (the x1 step does
    not depend on the bucket)."""
    key = (g, bucket if g > 1 else None)
    if key not in _PEAKS:
        _PEAKS[key] = analyze_train_step(cfg, DDP().plan(cfg, g),
                                         AdamWConfig(), 8, 32)["peak_bytes"]
    return _PEAKS[key]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bucket", [C.BUCKET_BYTES, SMALL_BUCKET])
def test_ddp_peaks_within_one_bucket_of_one_device(monkeypatch, bucket, n):
    monkeypatch.setattr(C, "BUCKET_BYTES", bucket)
    cfg = get_config("gemma3-4b").reduced(num_layers=4)
    grad_bytes = 4 * param_count(model_spec(cfg))
    assert grad_bytes > 100 * SMALL_BUCKET
    one, many = _peak(cfg, 1, bucket), _peak(cfg, n, bucket)
    assert many <= one + bucket + 0.01 * one, (one, many, grad_bytes)


def _bucket_sums(group, bucket):
    C.BUCKET_BYTES = bucket
    gen = torch.Generator().manual_seed(group.rank)
    ts = [torch.randn(3, 5, generator=gen),
          torch.randn(7, 4, 2, generator=gen).permute(2, 0, 1),
          torch.randn(64, generator=gen).to(torch.bfloat16),
          torch.randn(40, 20, generator=gen),          # > the bucket
          torch.randn(33, 9, generator=gen).t(),       # > the bucket
          torch.randn(2, generator=gen)]
    before = [t.clone() for t in ts]
    ids = [(id(t), t.stride()) for t in ts]
    axis = group.mesh((("data", group.size),)).axis("data")
    C.all_reduce_buckets(ts, axis)
    assert [(id(t), t.stride()) for t in ts] == ids
    return [b.float().numpy() for b in before], [t.float().numpy()
                                                 for t in ts]


def test_bucketed_sums_land_in_place():
    b0, got = spawn(_bucket_sums, ["cpu"] * 2, 1024)
    # rank 1's inputs, drawn the same way
    gen = torch.Generator().manual_seed(1)
    b1 = [torch.randn(3, 5, generator=gen),
          torch.randn(7, 4, 2, generator=gen).permute(2, 0, 1),
          torch.randn(64, generator=gen).to(torch.bfloat16),
          torch.randn(40, 20, generator=gen),
          torch.randn(33, 9, generator=gen).t(),
          torch.randn(2, generator=gen)]
    for x, y, g in zip(b0, b1, got):
        want = torch.from_numpy(x) + y.float()
        if y.dtype == torch.bfloat16:
            want = (torch.from_numpy(x).to(torch.bfloat16) + y).float()
        np.testing.assert_array_equal(g, want.numpy())


def _group_of_one(group, cfg, opt_cfg, params_np, batch_np):
    """On one rank (one torch thread): a step without a group, then a
    ddp step and a rules step as rank 0 of ``group``, from the same
    parameters."""
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim.adamw import init_opt_state
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    out = {}
    for name, plan, grp in (
            ("none", DDP().plan(cfg, 1), None),
            ("ddp", DDP().plan(cfg, 1), group),
            ("rules", rules_plan(cfg, (("data", 1), ("model", 1))), group)):
        job = BuiltJob(cfg, plan, opt_cfg, device="cpu", group=grp)
        params = job.shard(params_from_numpy(params_np, device="cpu"))
        p, o, m = job.step(params, init_opt_state(params),
                           job.place_batch(batch))
        out[name] = (params_to_numpy(p), {k: float(v) for k, v in m.items()})
    return out


def test_a_group_of_one_steps_bit_equal_to_no_group():
    cfg = get_config("xlstm-125m").reduced(num_layers=4)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params, _ = BuiltJob(cfg, DDP().plan(cfg, 1), opt_cfg,
                         device="cpu").init(3)
    batch = concrete_batch(cfg, 4, 16, device="cpu")
    got = spawn(_group_of_one, ["cpu"], cfg, opt_cfg,
                params_to_numpy(params),
                {k: v.numpy() for k, v in batch.items()})
    want_p, want_m = got["none"]
    for name in ("ddp", "rules"):
        gp, gm = got[name]
        assert gm == want_m, name
        for k in want_p:
            np.testing.assert_array_equal(gp[k], want_p[k], err_msg=name)
