"""Program-side entries, one module per entry the window calls, named by a
configuration's `entry`.  Each module has `Entry(config, lines, device,
tracing)` with:

- `request(req) -> np.ndarray`: one request, host work included, ending
  with the selection on the host (one copy);
- `answer(packed) -> dict`: that copy as a dict that carries `found`, an
  array over the request's agents (or agents and cycles) that the run
  reads; the rest of its form is what the configuration's comparison
  reads.  For `judge.compare` (a configuration without a `check`):
  per-agent `found` (A,), `best` (A,), `cost` (A,), `rows` (A, 12, N+1),
  `hist` (A, 11), and where the entry runs the responsibility post-pass
  `resp` (A, M), that term in every candidate's cost;
- `cycles` (optional, default 1): planning cycles per request, over which
  `cycle_ms_p95` divides a request's latency;
- `candidates` (optional, default agents × `candidates_per_agent`): real
  candidates per request, over all its cycles, which `cand_evals_per_s`
  counts;
- `k1_shape`: (table rows, columns, queries) of K1's launch per request;
- `risk_inputs(req)`: the arguments of `risk.costs.trajectory_risks` for
  the request, or None where the entry has no risk stack;
- `free()`: drop what the program holds.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.entries.{name}")
