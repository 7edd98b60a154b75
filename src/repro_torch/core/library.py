"""The Parallelism Library (paper Fig. 1): a registry of techniques that
users can extend with the two-function interface (``search_space`` +
``plan``) and reuse across execution sessions.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from ..models.config import ModelConfig
from ..parallelism.base import Technique
from ..parallelism.techniques import DEFAULT_TECHNIQUES


class ParallelismLibrary:
    def __init__(self, techniques: Optional[Iterable[Technique]] = None):
        self._techniques: Dict[str, Technique] = {}
        for t in (techniques if techniques is not None else DEFAULT_TECHNIQUES):
            self.register(t)

    def register(self, technique: Technique):
        """Register (or replace) a technique under ``technique.name``."""
        if not hasattr(technique, "search_space") or not hasattr(technique, "plan"):
            raise TypeError(
                "technique must implement the two-function interface "
                "(search_space, plan)")
        self._techniques[technique.name] = technique
        return technique

    def get(self, name: str) -> Technique:
        return self._techniques[name]

    def names(self) -> List[str]:
        return list(self._techniques)

    def items(self):
        return self._techniques.items()

    def candidates(self, cfg: ModelConfig, gpu_counts: Iterable[int]
                   ) -> List[Tuple[str, int]]:
        """All valid (technique, n_gpus) choices for a model — the search
        space the Trial Runner profiles and the Solver optimizes over."""
        out = []
        for g in gpu_counts:
            for name, t in self._techniques.items():
                if t.search_space(cfg, g):
                    out.append((name, g))
        return out

    # persistence: registered technique names survive across sessions
    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"techniques": self.names()}, f)

    @staticmethod
    def load(path: str, available: Optional[Iterable[Technique]] = None,
             strict: bool = True) -> "ParallelismLibrary":
        """Rebuild a library from saved technique names, resolved
        against ``available`` (default: the built-in techniques).

        Saved names missing from the pool raise ``KeyError`` listing
        them — a silently shrunken library would make the Solver skip
        choices the user thinks are registered.  ``strict=False``
        restores the old drop-silently behavior.
        """
        with open(path) as f:
            names = set(json.load(f)["techniques"])
        pool = {t.name: t for t in (available or DEFAULT_TECHNIQUES)}
        missing = sorted(names - set(pool))
        if missing and strict:
            raise KeyError(
                f"techniques {missing} are not in the available pool "
                f"{sorted(pool)}; register them (the ``available`` "
                f"argument) or pass strict=False to drop them")
        return ParallelismLibrary([pool[n] for n in names if n in pool])
