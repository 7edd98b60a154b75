"""Faults planted in the program's timed path, to show that ``correct``
catches them (the tests of this folder, and ``calibrate.py`` on the
card, whose readings set the limits' upper ends):

- ``unchanged``: the step returns its state unchanged (AdamW's update
  is skipped; the loss is still computed);
- ``half_batch``: half of the batch is left out and the mean taken over
  the rest (half of the rows, or of one row's positions where the
  batch is one row);
- ``token``: one token of every batch is altered where the feed makes
  it.

A cell of one card has no exchange between cards to leave out.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

FAULTS = ("unchanged", "half_batch", "token")


def _skip_update(opt_cfg, params, grads, state, gnorm=None):
    return params, state, {}


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The program with ``fault`` in its step (``unchanged``)."""
    if fault != "unchanged":
        yield
        return
    import repro_torch.parallelism.build as build
    import repro_torch.train.steps as steps
    old = steps.adamw_update, build.adamw_update
    steps.adamw_update = build.adamw_update = _skip_update
    try:
        yield
    finally:
        steps.adamw_update, build.adamw_update = old


def feed(fault: Optional[str], make: Callable[[int], dict], vocab: int
         ) -> Callable[[int], dict]:
    """The program's feed with ``fault`` in it (``half_batch``,
    ``token``)."""
    if fault == "half_batch":
        def half(i):
            t = make(i)["tokens"]
            b, s = t.shape
            return {"tokens": t[: b // 2] if b > 1 else t[:, : s // 2]}
        return half
    if fault == "token":
        def altered(i):
            t = make(i)["tokens"].clone()
            t[0, t.shape[1] // 2] = (t[0, t.shape[1] // 2] + 1) % vocab
            return {"tokens": t}
        return altered
    return make
