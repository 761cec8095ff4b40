"""Hierarchical execution timer (context-manager based).

Copy of `frenetix_tpu/utils/timers.py`, the JAX package's counterpart of the
reference planner's `ExecTimer` (its `risk_assessment/helpers/timers.py`):
nested `time_with_cm("a/b/c")` scopes accumulate wall-clock into a
slash-separated hierarchy, dumpable as a dict/JSON.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

__all__ = ["ExecTimer"]


class ExecTimer:
    def __init__(self, timing_enabled: bool = True):
        self.enabled = timing_enabled
        self._acc: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    @contextmanager
    def time_with_cm(self, path: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[path] = self._acc.get(path, 0.0) + dt
            self._counts[path] = self._counts.get(path, 0) + 1

    def get_timing_dict(self) -> dict:
        """Nested dict: path components become levels; leaves are
        {"total_s", "calls"}."""
        out: dict = {}
        for path, total in self._acc.items():
            node = out
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            # merge (inner scopes exit first, so children may already exist)
            leaf = node.setdefault(parts[-1], {})
            leaf["total_s"] = round(total, 6)
            leaf["calls"] = self._counts[path]
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.get_timing_dict(), f, indent=1)
