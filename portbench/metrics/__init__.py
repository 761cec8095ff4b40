"""Per-layer metric readers, one module per metric, named as in
BENCHMARK.json up to the first dot (`cycle_busy_ms.risk` is read by
`cycle_busy_ms.py`: the same quantity, moving another end-to-end metric).  Each has `read(run) -> float | None`: it reads the traced
run (`run.slice`, a `trace.Slice`; `run.captures`; `run.k1_shape`;
`run.entry` and `run.traced`, the slice's prepared requests) and returns
None where it finds nothing to read, so that the metric is left out."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}")
