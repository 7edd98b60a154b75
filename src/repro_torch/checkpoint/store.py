"""npz-based checkpoint store with end-to-end integrity, for trees of
tensors (nested dicts and lists).

The file format is the JAX package's, so a checkpoint written by either
package loads in the other: one ``.npz`` whose entries are the leaves
keyed by their "/"-joined tree paths (dict keys sorted, list indices),
bfloat16 widened losslessly to float32, plus the JSON metadata bundled
under ``__saturn_meta__``.

Commit protocol (single atomic commit point):

- The arrays AND the metadata (step counter, loss, content checksum) are
  written to a temp file and published with a single ``os.replace``: no
  reader can observe new arrays with stale metadata.
- Before publishing, the previous checkpoint is rotated to
  ``path + ".prev"``, the last-known-good fallback
  :func:`load_training_state` resumes from when the current file turns
  out corrupt or truncated.
- A sha256 content checksum over every array (name, dtype, shape,
  bytes) is stored in the bundled metadata and verified on load;
  mismatch raises :class:`CheckpointCorruptError`.
- A ``.meta.json`` sidecar is still written (atomically, after the
  commit) as a human-inspectable convenience; the bundled metadata is
  authoritative.

A sharded job (``parallelism.build.BuiltJob`` in a process group)
writes the same file: rank 0 writes the full tree that
``BuiltJob.full_state`` gathers, and on load each rank cuts its own part
out of the full arrays (``cut``).  So a checkpoint loads under any
(technique, device count), and in the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..models.params import params_to_numpy, tree_map_with_path

# npz entry under which the JSON metadata (incl. checksum) is bundled;
# the name cannot collide with tree paths (they never start with "__")
META_KEY = "__saturn_meta__"


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file is unreadable or fails its content checksum."""


def _content_checksum(arrays: dict) -> str:
    """sha256 over every array's (name, dtype, shape, bytes), in sorted
    key order — invariant to npz member ordering."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, tree: Any, metadata: Optional[dict] = None,
                    keep_previous: bool = True):
    """Atomically commit a tree + metadata to ``path`` (.npz).

    Arrays and metadata land in ONE file published by ONE
    ``os.replace`` (the single commit point); the metadata carries a
    content checksum verified on load.  With ``keep_previous`` the
    outgoing checkpoint is rotated to ``path + ".prev"`` as the
    last-known-good fallback.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = params_to_numpy(tree)
    meta = dict(metadata or {})
    meta["checksum"] = _content_checksum(arrays)
    payload = dict(arrays)
    payload[META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    if keep_previous and os.path.exists(path):
        os.replace(path, path + ".prev")
    _atomic_write(path, lambda f: np.savez(f, **payload))
    if metadata is not None:
        _atomic_write(path + ".meta.json",
                      lambda f: f.write(json.dumps(metadata).encode()))


def _read_bundle(path: str):
    """Load (arrays, bundled_meta_or_None); raises
    :class:`CheckpointCorruptError` on unreadable files or checksum
    mismatch.  Pre-checksum checkpoints (no bundled metadata) load
    without verification."""
    try:
        with np.load(path) as data:
            arrays = dict(data)
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable: {type(e).__name__}: {e}"
        ) from e
    meta = None
    raw = arrays.pop(META_KEY, None)
    if raw is not None:
        try:
            meta = json.loads(raw.tobytes().decode())
        except Exception as e:
            raise CheckpointCorruptError(
                f"checkpoint {path} has undecodable metadata: {e}") from e
        want = meta.get("checksum")
        if want is not None and _content_checksum(arrays) != want:
            raise CheckpointCorruptError(
                f"checkpoint {path} failed its content checksum")
    return arrays, meta


def verify_checkpoint(path: str) -> dict:
    """Integrity-check ``path`` without building a tree; returns the
    bundled metadata ({} for pre-checksum files).  Raises
    :class:`CheckpointCorruptError` on corruption."""
    _, meta = _read_bundle(path)
    return meta or {}


def load_checkpoint(path: str, like: Any, cut=None):
    """Restore into the structure of ``like`` (a tree of tensors), each
    leaf in its template's dtype and on its device, verifying the content
    checksum when present.  ``cut(path, array)`` maps a full array to the
    part ``like`` holds (a rank of a sharded job)."""
    arrays, _ = _read_bundle(path)

    def leaf(p, t):
        key = "/".join(p)
        try:
            arr = arrays[key]
        except KeyError:
            raise CheckpointCorruptError(
                f"checkpoint {path} is missing array {key!r}") from None
        if cut is not None:
            arr = cut(p, arr)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {path}: {key} is {arr.shape}, "
                             f"the job holds {tuple(t.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=t.device,
                                                   dtype=t.dtype)

    return tree_map_with_path(leaf, like)


def load_metadata(path: str) -> Optional[dict]:
    """Metadata for the checkpoint at ``path``: the bundled (atomic,
    checksummed) copy when present, else the ``.meta.json`` sidecar.
    The internal checksum entry is stripped."""
    if os.path.exists(path):
        try:
            _, meta = _read_bundle(path)
        except CheckpointCorruptError:
            meta = None
        if meta is not None:
            return {k: v for k, v in meta.items() if k != "checksum"}
    sidecar = path + ".meta.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return None


def load_training_state(path: str, params: Any, opt: Any, cut=None):
    """Resume helper: restore ``(params, opt, start_step)`` from
    ``path`` if a checkpoint exists there, else return the inputs
    unchanged at step 0 (``cut`` as in :func:`load_checkpoint`).

    Validates before trusting: a checkpoint that is unreadable or fails
    its content checksum is skipped with a recorded warning and the
    previous good checkpoint (``path + ".prev"``) is tried instead; if
    that fails too, the run restarts from step 0 — never raises mid-run
    over a bad file.
    """
    like = {"params": params, "opt": opt}
    for i, p in enumerate((path, path + ".prev")):
        if not os.path.exists(p):
            continue
        try:
            meta = verify_checkpoint(p)
            state = load_checkpoint(p, like, cut)
        except CheckpointCorruptError as e:
            warnings.warn(
                f"skipping corrupt checkpoint: {e}; "
                + ("falling back to previous good checkpoint"
                   if i == 0 else "restarting from step 0"),
                RuntimeWarning, stacklevel=2)
            continue
        if not meta:
            meta = load_metadata(p) or {}
        if i > 0:
            warnings.warn(
                f"resumed from previous good checkpoint {p} "
                f"(step {int(meta.get('step', 0))})",
                RuntimeWarning, stacklevel=2)
        return state["params"], state["opt"], int(meta.get("step", 0))
    return params, opt, 0
