"""Decode in the port's dry run at (data 2, model 4): rank 0's flops of
one greedy step against the reference's loop-aware HLO analysis
(tests/_torch_dryrun.py) for reduced h2o-danube-3-4b, olmoe-1b-7b,
recurrentgemma-2b and stablelm-12b, their L 64 caches placed by
``cache_shardings`` under the "heads" and the "seq" policy; and, on
traced steps, that no collective takes a KV cache part.

At B 16 the batch is cut over data and they agree within 5%.  At B 1
(the long-context archs) the batch rule is None: every rank runs the
same row, so the port's rank keeps the weights cut over data ("embed")
where they lie and splits their dots' contraction, all-reducing the
partial sums, as GSPMD partitions the reference's step
(``context.contract_for``).  There they agree within 5% too (the
function keeps the name it had while they departed), the collective
payload stays within 4x of the reference's, and no weight matrix part,
nor a copy of one, enters a collective; where the batch is cut the
gathers of the weights' "embed" cuts are still there."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_dryrun import (FLOPS_REL, MESHES, SEQ, decode_combos, port,
                           reference_decode)
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import build_lowerable, optimized_overrides
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models.config import InputShape
from repro_torch.models.params import tree_leaves_with_paths
from repro_torch.models.transformer import model_spec

MESH = "2x4"
COMBOS = decode_combos()
B1 = [(a, p) for a, p, b in COMBOS if b == 1]
# the reference's payload is a few KB at B 1; the port's may take up to
# this many times as much
PAYLOAD_X = 4.0


@pytest.fixture(scope="module")
def ref():
    return reference_decode(MESH)


@pytest.mark.parametrize("arch,policy", [(a, p) for a, p, b in COMBOS
                                         if b == 16])
def test_decode_flops_agree_where_the_batch_is_cut(ref, arch, policy):
    want = ref[f"{arch}|{policy}|16"]["flops"]
    got = port(arch, "decode", MESH, policy, 16)["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), got / want


@pytest.mark.parametrize("arch,policy", B1)
def test_decode_flops_depart_at_one_row(ref, arch, policy):
    want = ref[f"{arch}|{policy}|1"]["flops"]
    got = port(arch, "decode", MESH, policy, 1)["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), got / want


@pytest.mark.parametrize("arch,policy", B1)
def test_decode_payload_near_the_reference_at_one_row(ref, arch, policy):
    want = ref[f"{arch}|{policy}|1"]["collectives"]["total"]
    got = port(arch, "decode", MESH, policy, 1)["collectives"]["total"]
    assert 0 < got <= PAYLOAD_X * want, got / want


class _Watch(TorchDispatchMode):
    """Records every c10d op, and each one whose tensor arguments share
    storage with ``storages`` or with a copy of them (a clone, a dtype
    or layout copy, a concatenation)."""

    COPIES = ("clone", "_to_copy", "copy_", "cat", "stack")

    def __init__(self, storages):
        super().__init__()
        self.storages, self.ops, self.hits = set(storages), 0, []
        self.copies = []

    @staticmethod
    def _tensors(*trees):
        flat, out = list(trees), []
        while flat:
            a = flat.pop()
            if isinstance(a, (list, tuple)):
                flat.extend(a)
            elif isinstance(a, dict):
                flat.extend(a.values())
            elif isinstance(a, torch.Tensor):
                out.append(a)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        touched = any(t.untyped_storage()._cdata in self.storages
                      for t in self._tensors(args, kwargs))
        if func.namespace == "c10d":
            self.ops += 1
            if touched:
                self.hits.append(str(func))
        elif touched and func._schema.name.split("::")[-1] in self.COPIES:
            # kept alive, so that no later tensor takes a copy's storage
            self.copies.extend(self._tensors(out))
            self.storages.update(t.untyped_storage()._cdata
                                 for t in self.copies)
        return out


# (arch, policy, batch, mesh) and the cut the cache part must show:
# head_dim (rgemma's one kv head), kv heads, sequence over model, and at
# B 1 sequence over data (with kv heads over model) or over (data, model)
CACHE_CUTS = [("recurrentgemma-2b", "heads", 16, (("data", 2), ("model", 4)),
               "head_dim"),
              ("h2o-danube-3-4b", "heads", 16, (("data", 2), ("model", 4)),
               "kv_heads"),
              ("stablelm-12b", "seq", 16, (("data", 2), ("model", 4)), "seq"),
              ("h2o-danube-3-4b", "heads", 1, (("data", 2), ("model", 4)),
               "seq"),
              ("h2o-danube-3-4b", "seq", 1,
               (("pod", 2), ("data", 2), ("model", 2)), "seq"),
              ("olmoe-1b-7b", "seq", 16,
               (("pod", 2), ("data", 2), ("model", 2)), "seq")]


@pytest.mark.parametrize("arch,policy,batch,mesh,cut", CACHE_CUTS)
def test_no_kv_cache_part_enters_a_collective(arch, policy, batch, mesh,
                                              cut):
    cfg = get_config(arch).reduced(num_layers=4)
    fn, args, plan = build_lowerable(
        cfg, InputShape("x", 64, batch, "decode"), mesh,
        "pod" in dict(mesh), cache_policy=policy)
    dim = {"seq": 1, "kv_heads": 2, "head_dim": 3}[cut]
    full = {"seq": 64, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim}[cut]
    seen = {}

    def watched(params, tokens, state):
        caches = [t for p, t in tree_leaves_with_paths(state["layers"])
                  if p[-1] in ("k", "v")]
        assert caches and all(t.shape[-4 + dim] < full for t in caches)
        seen["watch"] = _Watch({t.untyped_storage()._cdata
                                for t in caches})
        with seen["watch"]:
            return fn(params, tokens, state)

    analyze_step(watched, args, world_size=plan.n_devices)
    assert seen["watch"].ops > 0
    assert seen["watch"].hits == []


# (arch, batch, mesh of tests/_torch_dryrun.py's MESHES, the optimized
# preset's overrides, whether the weights stay in place): the batch rule
# None at B 1, and under the optimized preset at B 16 (the MoE decode:
# the caches' rows cut, the activations' whole); at B 16 on (data 2,
# model 4) the batch is cut and the step gathers the weights' "embed"
# cuts
WEIGHT_CASES = [("h2o-danube-3-4b", 1, "2x4", False, True),
                ("h2o-danube-3-4b", 1, "2x2x2", False, True),
                ("recurrentgemma-2b", 1, "2x4", False, True),
                ("recurrentgemma-2b", 1, "2x2x2", False, True),
                ("olmoe-1b-7b", 16, "2x4", True, True),
                ("olmoe-1b-7b", 16, "2x2x2", True, True),
                ("h2o-danube-3-4b", 16, "2x4", False, False)]


@pytest.mark.parametrize("arch,batch,mesh,optimized,in_place", WEIGHT_CASES)
def test_no_weight_matrix_part_enters_a_collective_where_the_batch_is_whole(
        arch, batch, mesh, optimized, in_place):
    cfg = get_config(arch).reduced(num_layers=4)
    shape = InputShape("x", SEQ, batch, "decode")
    kw = optimized_overrides(cfg, shape) if optimized else {}
    dims, names, multi_pod, _ = MESHES[mesh]
    fn, args, plan = build_lowerable(
        cfg, shape, tuple(zip(names, dims)), multi_pod,
        rules_override=kw.get("rules_override"),
        cache_policy=kw.get("cache_policy", "heads"))
    assert (plan.rules.get("batch") is None) == in_place
    # every leaf with two dims or more besides a stacked layer dim (a
    # norm's scale, one activation row, may still be gathered)
    matrices = {p for p, s in tree_leaves_with_paths(model_spec(cfg))
                if sum(a != "layers" for a in s.axes) > 1}
    seen = {}

    def watched(params, tokens, state):
        parts = [t for p, t in tree_leaves_with_paths(params)
                 if p in matrices]
        assert len(parts) == len(matrices)
        seen["watch"] = _Watch({t.untyped_storage()._cdata for t in parts})
        with seen["watch"]:
            return fn(params, tokens, state)

    analyze_step(watched, args, world_size=plan.n_devices)
    assert seen["watch"].ops > 0
    if in_place:
        assert seen["watch"].hits == []
    else:
        assert seen["watch"].hits
