"""Program-side entries, one module per entry the window calls, named by a
configuration's `entry`.  Each module has `Entry(config, lines, device,
tracing)` with:

- `request(req) -> np.ndarray`: one replanning request, host work
  included, ending with the selection on the host (one copy);
- `answer(packed) -> dict`: that copy as per-agent `found` (A,), `best`
  (A,), `cost` (A,), `rows` (A, 12, N+1), `hist` (A, 11), and where the
  entry runs the responsibility post-pass `resp` (A, M), that term in
  every candidate's cost;
- `k1_shape`: (table rows, columns, queries) of K1's launch per request;
- `risk_inputs(req)`: the arguments of `risk.costs.trajectory_risks` for
  the request, or None where the entry has no risk stack;
- `free()`: drop what the program holds.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.entries.{name}")
