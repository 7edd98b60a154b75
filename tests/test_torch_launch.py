"""The port's launch-layer units (src/repro_torch/launch/mesh.py and
dryrun.py's presets): the JAX package's tests/test_launch.py on the
port, and the port's rules, presets and cache placements held equal to
the reference's.

- ``production_param_rules`` and ``activation_rules``: equal to the
  reference's dicts for every arch and shape on both production meshes
  and at (data 2, model 4);
- ``optimized_overrides``: equal to the reference's for every arch and
  shape, ``attn_fn`` compared by the (q, kv) chunks it picks at several
  sequence lengths;
- ``cache_shardings``: every decode-state leaf's placement equal to the
  reference's ``PartitionSpec`` at (data 2, model 4) and (pod 2, data 2,
  model 2), both policies, for a dense, a windowed, an MoE and two
  recurrent archs at decode_32k and long_500k.  The reference runs in a
  subprocess with 8 host devices (``jax.sharding.Mesh`` over them), as
  tests/test_parallelism.py does.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jax_mesh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import optimized_overrides
from repro_torch.launch.mesh import (_axis_sizes, activation_rules,
                                     cache_shardings, make_production_mesh,
                                     production_param_rules)
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import tree_leaves_with_paths
from repro_torch.models.transformer import model_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": make_production_mesh(multi_pod=False),
          "multipod": make_production_mesh(multi_pod=True),
          "2x4": (("data", 2), ("model", 4))}
CACHE_ARCHS = ["stablelm-12b", "gemma3-4b", "olmoe-1b-7b",
               "recurrentgemma-2b", "xlstm-125m"]
CACHE_MESHES = {"2x4": ((2, 4), ("data", "model"), False),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"), True)}
CACHE_SHAPES = ["decode_32k", "long_500k"]
POLICIES = ["heads", "seq"]


class FakeMesh:
    """The reference mesh's ``axis_names`` and ``devices.shape``."""

    def __init__(self, mesh_axes):
        self.axis_names = tuple(a for a, _ in mesh_axes)
        self.devices = type("D", (), {
            "shape": tuple(n for _, n in mesh_axes)})()


# ------------------------------------------------ tests/test_launch.py

def test_production_rules_divisibility():
    """Every rule the builder emits must divide its logical axis sizes
    by the mesh axis size (this is what guarantees the placement)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        rules = production_param_rules(cfg, MESHES["pod"], False)
        spec = model_spec(cfg)
        for logical, mesh_ax in rules.items():
            if mesh_ax is None:
                continue
            n = {"data": 16, "model": 16}[mesh_ax]
            for s in _axis_sizes(spec, logical):
                assert s % n == 0, (arch, logical, s, n)


def test_gemma3_heads_not_sharded():
    rules = production_param_rules(get_config("gemma3-4b"), MESHES["pod"],
                                   False)
    assert "heads" not in rules          # 8 heads % 16 != 0
    assert rules.get("ffn") == "model"   # 10240 % 16 == 0
    assert rules.get("vocab") == "model"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_optimized_preset_well_formed(arch, shape_name):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    kw = optimized_overrides(cfg, shape)
    assert isinstance(kw.get("extra_opts", {}), dict)
    ro = kw.get("rules_override")
    if shape.mode == "decode":
        # windowed archs keep the heads cache policy (measured better)
        if cfg.window_size:
            assert kw.get("cache_policy", "heads") == "heads"
        elif cfg.has_global_attention():
            assert kw.get("cache_policy") == "seq"
    if shape.mode == "train" and not cfg.is_moe:
        assert ro and "batch" in ro      # DP/FSDP over both axes


# ------------------------------------------------ against the reference

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_the_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh_axes = MESHES[mesh]
    multi_pod = mesh == "multipod"
    assert production_param_rules(cfg, mesh_axes, multi_pod) == \
        jax_mesh.production_param_rules(jcfg, FakeMesh(mesh_axes),
                                        multi_pod)
    for name, shape in INPUT_SHAPES.items():
        from repro.models.config import INPUT_SHAPES as JAX_SHAPES
        assert activation_rules(cfg, shape, multi_pod) == \
            jax_mesh.activation_rules(jcfg, JAX_SHAPES[name], multi_pod), \
            name


def _chunks(attn_fn, module, monkeypatch, s):
    """The (q_chunk, kv_chunk) that ``attn_fn`` hands ``module``'s
    blockwise attention at sequence length ``s``."""
    got = {}

    def fake(q, k, v, *, window, q_chunk, kv_chunk):
        got["chunks"] = (q_chunk, kv_chunk)
    monkeypatch.setattr(module, "blockwise_attention", fake)
    q = type("Q", (), {"shape": (1, s, 4, 64)})()
    attn_fn(q, q, q, 0)
    return got["chunks"]


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimized_overrides_equal_the_reference(arch, shape_name,
                                                 monkeypatch):
    import jax
    # the reference's dryrun sets XLA_FLAGS to 512 host devices when it
    # is imported: with JAX's backend up first, this worker keeps its
    # device count, and the flag is put back for its later tests
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.models.blockwise as jax_blockwise
    from repro.launch.dryrun import optimized_overrides as jax_overrides
    from repro.models.config import INPUT_SHAPES as JAX_SHAPES
    import repro_torch.models.blockwise as blockwise
    kw = optimized_overrides(get_config(arch), INPUT_SHAPES[shape_name])
    jkw = jax_overrides(jax_get_config(arch), JAX_SHAPES[shape_name])
    assert set(kw) == set(jkw)
    opts, jopts = kw.pop("extra_opts"), jkw.pop("extra_opts")
    assert kw == jkw
    assert set(opts) == set(jopts)
    for k in opts:
        if k != "attn_fn":
            assert opts[k] == jopts[k], k
            continue
        for s in (2048, 3072, 4096, 32768):
            assert _chunks(opts[k], blockwise, monkeypatch, s) == \
                _chunks(jopts[k], jax_blockwise, monkeypatch, s), s


_REFERENCE = r'''
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch.mesh import cache_shardings
from repro.models.config import INPUT_SHAPES
archs, meshes, shapes, policies = json.loads(sys.argv[1])
out = {}
for arch in archs:
    for mname, (shape, names, multi_pod) in meshes.items():
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), tuple(names))
        for sname in shapes:
            for policy in policies:
                sh, _ = cache_shardings(get_config(arch), INPUT_SHAPES[sname],
                                        mesh, multi_pod, policy=policy)
                leaves = jax.tree_util.tree_leaves_with_path(sh)
                out[f"{arch}|{mname}|{sname}|{policy}"] = {
                    "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path): list(s.spec)
                    for path, s in leaves}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_caches():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps([CACHE_ARCHS, CACHE_MESHES, CACHE_SHAPES, POLICIES])
    out = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _as_json(entry):
    """An entry as JSON gives it, a tuple of one axis as that axis (the
    reference's ``PartitionSpec`` holds ``("data",)`` as ``"data"``)."""
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else list(entry)
    return entry


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape_name", CACHE_SHAPES)
@pytest.mark.parametrize("mesh", list(CACHE_MESHES))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_shardings_equal_the_reference(reference_caches, arch, mesh,
                                             shape_name, policy):
    shape, names, multi_pod = CACHE_MESHES[mesh]
    placements, spec = cache_shardings(
        get_config(arch), INPUT_SHAPES[shape_name],
        tuple(zip(names, shape)), multi_pod, policy=policy)
    want = reference_caches[f"{arch}|{mesh}|{shape_name}|{policy}"]
    got = {}
    for path, leaf in tree_leaves_with_paths(spec):
        at = placements
        for k in path:
            at = at[int(k)] if isinstance(at, list) else at[k]
        assert len(at) == len(leaf.shape) or not leaf.shape, path
        got["/".join(path)] = [_as_json(e) for e in at]
    # the reference drops a PartitionSpec's trailing Nones
    pad = {k: [_as_json(e) for e in v] + [None] * (len(got.get(k, v))
                                                   - len(v))
           for k, v in want.items()}
    assert got == pad
    assert any(e is not None for v in got.values() for e in v)
