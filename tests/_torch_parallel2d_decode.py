"""Shared by tests/test_torch_parallel2d_decode_*.py: decode under the dry
run's 2-D and 3-D rules plans (``repro_torch.testing.parallel_check``'s
``rules_plan``) on four gloo ranks, held against the JAX package's
``decode_step`` on one device.

Each arch spawns its four ranks once, and they run every case on both
meshes, (data 2, model 2) and (pod 2, data 1, model 2)
(``parallel_check.decode_runs_on``).  A case is a cache policy
(``launch.mesh.cache_shardings``: "heads" cuts the KV cache by kv heads
or head_dim, "seq" by sequence, and at B 1 the sequence is cut over
data as well), a batch, and rules over ``rules_plan``'s (``{"batch":
None}``: every rank runs every row, where the cache's rows may still be
cut).  The weights are the JAX init with wq, wk and wv rescaled
(tests/test_torch_families.py says why), in fp32.  The state is fp32,
its KV caches of length L 64, drawn by ``random_decode_state`` (finite
stabilizers) in the layout of the JAX package's ``init_decode_state``,
at ``pos`` 41: under a sequence cut over model the write lands on model
rank 1, and the window of 32 spans both model ranks.  Three greedy
steps follow, each feeding back the argmax, on the ranks and in JAX:

- each step's tokens equal, and each rank's part of its logits (its
  rows, its vocab part) within LOGITS_ATOL 1e-4
  (tests/_torch_parallel2d.py);
- after the last step each rank's part of every state leaf within
  STATE_REL 5e-5 of the leaf's largest value, its ``pos`` 44.
"""
import jax
import jax.numpy as jnp
import numpy as np

import _torch_port  # noqa: F401  (thread cap)
from _torch_parallel2d import LOGITS_ATOL, STATE_REL
from test_torch_model import _rescale
from test_torch_parallelism import SPAWN_TIMEOUT_S, _cfgs
from repro.checkpoint.store import _flatten_with_paths
from repro.models import transformer as jt
from repro_torch.parallelism.dist import spawn
from repro_torch.testing.parallel_check import (DECODE_STEPS, MESHES,
                                                decode_case, decode_runs_on,
                                                expected_part,
                                                random_decode_state)

L, POS = 64, 41


def _key(path):
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                    for p in path)


def jax_state(jcfg, batch, state_np):
    """The JAX package's ``init_decode_state`` in fp32 with the arrays of
    ``state_np`` (its layout: every path and shape must agree)."""
    init = jt.init_decode_state(jcfg, batch, L, jnp.float32)
    flat = {k: v for k, v in _flatten_with_paths(init).items() if k != "pos"}
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in state_np.items()}
    state = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(state_np[_key(p)]) if _key(p) != "pos"
        else x, init)
    state["pos"] = jnp.asarray(POS, jnp.int32)
    return state


class DecodeRuns:
    """One arch's spawn over ``cases`` (name -> (policy, B, rules)) and
    the JAX decode of each batch, made on first use."""

    def __init__(self, arch, cases):
        self.arch, self.cases = arch, cases
        self._done = None

    def __call__(self, mesh, name):
        if self._done is None:
            self._done = self._run()
        d = self._done
        policy, b, _ = self.cases[name]
        return {"cfg": d["cfg"], "parts": d["got"][mesh][name],
                "jax": d["jax"][b], "mesh": mesh}

    def _run(self):
        jcfg, cfg = _cfgs(self.arch)
        jparams = _rescale(jcfg, jt.init_model(jcfg, jax.random.PRNGKey(1)))
        step = jax.jit(lambda p, t, s: jt.decode_step(p, jcfg, t, s))
        inputs, ref = {}, {}
        for b in sorted({b for _, b, _ in self.cases.values()}):
            state_np = random_decode_state(cfg, b, L, seed=b)
            tokens = np.random.RandomState(100 + b).randint(
                0, cfg.vocab_size, (b, 1)).astype(np.int32)
            inputs[b] = (tokens, state_np)
            state, tok, steps = jax_state(jcfg, b, state_np), tokens, []
            for _ in range(DECODE_STEPS):
                logits, state = step(jparams, tok, state)
                tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
                steps.append({"logits": np.asarray(logits, np.float32),
                              "tokens": np.asarray(tok)})
            ref[b] = {"steps": steps, "pos": int(state["pos"]),
                      "state": {k: np.asarray(v, np.float32) for k, v in
                                _flatten_with_paths(state["layers"]).items()}}
        cases = {name: decode_case(policy, *inputs[b], POS, L, rules)
                 for name, (policy, b, rules) in self.cases.items()}
        got = spawn(decode_runs_on, ["cpu"] * 4, cfg,
                    _flatten_with_paths(jparams), cases, MESHES,
                    timeout_s=SPAWN_TIMEOUT_S)
        return {"cfg": cfg, "got": got, "jax": ref}


def check_steps(case):
    """Every rank's tokens and logits of each step against JAX's."""
    mesh_axes = MESHES[case["mesh"]]
    parts = case["parts"]
    assert len(parts) == 4
    assert len({tuple(sorted(p["coords"].items())) for p in parts}) == 4
    for part in parts:
        for t, (got, want) in enumerate(zip(part["steps"],
                                            case["jax"]["steps"])):
            where = (part["coords"], t)
            pl = part["logits_placement"]
            tok = expected_part(want["tokens"], got["tokens"].shape,
                                part["coords"], mesh_axes, 0, pl[:2])
            np.testing.assert_array_equal(got["tokens"], tok,
                                          err_msg=str(where))
            logits = expected_part(want["logits"], got["logits"].shape,
                                   part["coords"], mesh_axes, 0, pl)
            np.testing.assert_allclose(got["logits"], logits,
                                       atol=LOGITS_ATOL, rtol=0,
                                       err_msg=str(where))


def check_state(case, cut=()):
    """Every rank's part of every state leaf after the last step against
    JAX's; each leaf placed as ``cache_shardings`` places it, and each
    leaf named in ``cut`` (a path suffix) is cut on some dim."""
    mesh_axes = MESHES[case["mesh"]]
    full = case["jax"]["state"]
    for part in case["parts"]:
        assert part["pos"] == case["jax"]["pos"] == POS + DECODE_STEPS
        assert set(part["state"]) == set(full)
        for k, v in part["state"].items():
            want = expected_part(full[k], v.shape, part["coords"],
                                 mesh_axes, None, part["layout"][k])
            assert want.shape == v.shape, (k, want.shape, v.shape)
            if any(k.endswith(c) for c in cut):
                assert v.size < full[k].size, (k, part["layout"][k])
            err = np.abs(v - want).max()
            assert err <= STATE_REL * np.abs(want).max(), \
                (part["coords"], k, err, np.abs(want).max())


def decode_group_of_one(group, runs):
    """Per rank (a group of one): for each (name, cfg, params_np, case)
    of ``runs``, :data:`DECODE_STEPS` greedy steps without a group and
    under the rules plan on (data 1, model 1), as rank 0 of ``group``,
    the state placed by ``cache_shardings``; both runs' logits and
    tokens of each step and last state, as numpy, by name."""
    import torch

    from repro_torch.launch.mesh import cache_shardings
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import (params_from_numpy,
                                           tree_leaves_with_paths)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallelism.build import BuiltJob
    from repro_torch.testing.parallel_check import (_decode_state,
                                                    greedy_decode, rules_plan)
    mesh = (("data", 1), ("model", 1))
    out = {}
    for name, cfg, params_np, case in runs:
        got = {}
        for how in ("no_group", "group"):
            params = params_from_numpy(params_np, device="cpu")
            state = _decode_state(case["state"], case["pos"], "cpu")
            tokens = torch.as_tensor(case["tokens"])
            job = layout = None
            if how == "group":
                layout, _ = cache_shardings(
                    cfg, InputShape("decode", case["length"],
                                    tokens.shape[0], "decode"),
                    mesh, False, policy=case["policy"])
                job = BuiltJob(cfg, rules_plan(cfg, mesh, rules_override=
                                               case["rules"]),
                               AdamWConfig(), group=group)
                params = job.shard(params)
                state = job.shard_state(state, layout)
            steps, state = greedy_decode(cfg, params, tokens, state,
                                         DECODE_STEPS, job, layout)
            got[how] = {
                "steps": [(lg.numpy(), t.numpy()) for lg, t in steps],
                "state": {"/".join(p): t.numpy() for p, t in
                          tree_leaves_with_paths(state)}}
        out[name] = got
    return out


def greedy_parts(group, logits):
    """Per rank of a group of two, the vocab cut over ("model", 2) by the
    rules: ``greedy_tokens`` of the rank's half of ``logits`` (B, 1, V)."""
    import torch

    from repro_torch.models.transformer import greedy_tokens
    from repro_torch.parallelism.context import axis_rules
    mesh = group.mesh((("model", 2),))
    part = torch.as_tensor(logits).chunk(2, dim=-1)[group.rank]
    with axis_rules({"vocab": "model"}, mesh):
        return greedy_tokens(part).numpy()
