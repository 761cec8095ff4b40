#!/usr/bin/env python3
"""Smoke run of the PyTorch port (frenetix_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each printed on lines of its own:

1. device: a CUDA device must exist and be Hopper (compute capability 9.x);
   prints the card's name and power limit; TF32 is switched off.
2. build: compiles the K1 kernel (csrc/table_interp.cu), K2
   (csrc/rollout.cu), K3 (csrc/cycle.cu) and kernel Q
   (csrc/risk_quadrature.cu) with nvcc; prints ptxas's register report.
3. K1 against its plain PyTorch twin on the card, at the dense cycle's
   shapes (R = 868, C = 7, P = 1,079,296), at the simulations' P = 1024 x 31
   and at a ragged P, in float32 and float64: the outputs must be bitwise
   equal.  Times both with CUDA events, and an empty kernel launched the
   same way: the floor of one launch, which bounds K1 at small P.  At the
   dense, sim-sized and stacked shapes also the nearest single PyTorch call,
   `grid_sample` (bilinear, border, align_corners) on the table as a
   (1, C, 1, R) image, timed as K1 is, with its max |Δ| against the plain
   twin over all λ and where 0 <= λ < 1 (not the same function: it rounds
   the coordinate and does not extend a segment beyond [0, 1)).
4. dense cycle: the bench problem (34,816 candidates, 4 obstacles,
   corridor) through planner.core.evaluate_cycle on the card in float32;
   `found` must hold, the kernel must have launched, and best_idx must equal
   the CPU float64 run's (or the two costs lie within 4 float32 ulps).
5. simulation: run_scenario on the highway and overtake families on the
   card at float32; every agent must reach its goal through the kernel.
6. batched cycle: a stacked problem of A = 8 agents (567 candidates padded
   to M = 1024, N + 1 = 31, per-agent tables of different R padded to a
   common R) through parallel.mesh.batched_full_cycle on the card in
   float32; per agent `best` must equal the CPU float64 *sequential*
   evaluate_cycle (or the two float64 costs lie within 4 float32 ulps), and
   every batched call must launch K1 exactly once.  Times the batched call
   and the 8 sequential cycles with CUDA events.
7. multi-agent simulation: convoy (7 vehicles + ego, A = 8) and highway with
   start_multiagent, batched on the card in float32: every agent must reach
   its goal through the kernel; compared with the sequential multi-agent run
   on the card (equal statuses and step counts) and with the port's CPU
   float32 batched run (equal statuses and steps, end positions within
   F32_CPU_TOL).
8. risk: risk.costs.trajectory_risks on a simulation-sized rollout with 4
   obstacles on the card in float32 against the CPU float64 result
   (1e-4 absolute), and a scenario with emergency_mode = "min_risk" whose
   planner runs the min_risk branch on the card at least once.

9. responsibility: the highway with start_multiagent and
   cost_weights["responsibility"] = 0.2, batched and sequential on the card
   in float32 (equal statuses and steps, every agent at its goal), against
   the first steps of the CPU float64 run; then one `batched_full_cycle`
   with `resp_weight` on phase 6's stacked problem padded to 16 obstacle
   slots, with reach grids that make the term differ between candidates:
   per agent `best` must equal the CPU float64 run's (or tie within 4
   float32 ulps); timed beside the same cycle without the term.
10. sensing and occlusion: a truck parked beside the lane (a blind spot),
   the occlusion module on with occ_um = 2.0 and occ_ve = 0.5 and
   `calc_occlusions`, two agents, batched and sequential on the card in
   float32: every agent at its goal, equal statuses, the ego's executed
   states equal; the ego passes the truck slower than with the module off; the
   gate must have removed the first choice in some cycle.  Then
   `polar_visibility_batch` on the card against `polar_visibility` on the
   host at 720 rays.

11. device-resident run: the convoy (A = 8, 264 steps) and the highway with
   start_multiagent (A = 2) through parallel.device_sim.DeviceSimulation on
   the card in float32, as the eager loop and as the replayed CUDA graph,
   against phase 7's sequential host run: the loop runs under
   torch.cuda.set_sync_debug_mode("error"), each run makes one device-to-host
   copy, the replayed run equals the eager run bitwise, statuses and steps
   equal the host run's and positions lie within 1e-4 m of it, and K1's
   launches are programs per cycle x cycles (counted launches of the eager
   loop; for the replayed run the launches recorded in the graph x replays).
12. fleet: workloads.device_fleet(8) through parallel.device_sim.run_fleet on
   the card, every member against its solo run (equal statuses and steps,
   positions within 1e-4 m), then timed at S = 1, 8, 32: wall, scenarios per
   second, peak device memory.

13. behavior planner:
   (a) the host path, one agent: traffic_light, stop_sign and lane_change in
   float32 and float64 on the card; the float64 run must equal the CPU
   float64 run of the port (statuses, steps, positions within 1e-6 m); the
   float32 run is held against the port's CPU float32 run, both traced
   (`utils.parting`): equal statuses, positions within F32_CPU_TOL up to the
   first cycle whose selection differs, and that cycle a float32 cost tie or
   threshold flip (`classify_parting`), else equal steps;
   (b) the convoy with behavior, host batched against host sequential on the
   card: equal statuses, positions within 1e-4 m up to the first retirement;
   (c) the device-resident run with the FSM in the run on traffic_light,
   stop_sign, yield_sign, crosswalk and convoy: float32 eager and replayed
   (bitwise equal, one fetch, sync debug mode "error"), then float64 equal
   to the hybrid run and the host sequential run (statuses, steps, positions
   within 1e-6 m); ms per cycle eager and replayed, capture time; then
   float32 against float32: the replayed run against the port's CPU float32
   device run of the family, both eager runs traced (`utils.parting.
   RunTrace`; the card's traced run equals its replayed run bitwise): equal
   statuses, positions within F32_CPU_TOL up to the first cycle whose
   selection differs, that cycle and agent named and a float32 cost tie or
   threshold flip (`classify_run_parting`), else equal steps; the replayed
   run with `emit_margins` (a graph of its own) equal to the plain replayed
   run bitwise with one fetch, at a tie the margin within 4 float32 ulps;
   per family the smallest positive live margin in float32 ulps, the live
   selections under 4 ulps, and the stopping-flip share (flagged / on
   target) of the card's run and the CPU's;
   (d) hybrid: lane_change falls back at construction, behavior_overtake
   bails at run time; both equal the forced "hybrid" run (float64); ms per
   cycle, fetches and captures per run;
   (e) a behavior fleet of traffic_light, stop_sign and convoy (float32,
   FSM in the run) against the members' solo runs; scenarios per second and
   peak memory; the fleet with `emit_margins` (one fetch) equal to the plain
   fleet bitwise, each member's margins within F32_MARGIN_ULPS float32 ulps
   of its solo run's wherever the member selects as its solo run does.

14. post-passes in the device-resident run (float32 unless said):
   (a) the highway with start_multiagent and responsibility 0.2, and (b) the
   blind spot with the occlusion module (occ_um 2.0, occ_ve 0.5) and
   `calc_occlusions`, each eager and replayed under sync debug mode "error"
   with one fetch: replayed = eager bitwise, statuses and steps equal phase
   9's / 10's host sequential run, positions within 1e-4 m, K1 launches =
   programs x cycles; ms per cycle eager and replayed, and the window slots
   the run keeps of the nominal 16;
   (c) the traffic light with the behavior planner and responsibility 0.2 in
   float64, the FSM in the run, equal to the hybrid run and the host
   sequential run (statuses, steps, positions within 1e-6 m);
   (d) a responsibility fleet of three (highway, two-agent overtake, curve:
   `workloads.device_fleet(3)`), every member against its solo run;
   (e) the window slots the run keeps of the nominal 16, per family.

15. the command line on the card (`run_scenario.main` in this process, into
   fresh temporary directories; SQLite must have STRICT tables, >= 3.37):
   (a) `highway --evaluate`: exit 0, score_overview.csv, simulation.db with
   its five tables, the agent's trajectories.db and logs.csv, the solution
   XML, no log_failures.csv; against the same call with `--device cpu --set
   dtype=float64`: the same tables and row counts, equal statuses and steps,
   executed positions within 1e-4 m, the same metric columns;
   (b) `convoy --multiagent --batched-agents --evaluate`: results rows and a
   solution XML for all 8 agents;
   (c) `highway --multiagent --device-sim --evaluate` and (d) `highway
   overtake --device-fleet --evaluate`: one fetch per run, K1 launches =
   programs x cycles (recorded x replays), the log set of the JAX package's
   device path (meta and evaluation rows, no per-step or results rows) and
   none for the fleet, as the JAX package's fleet;
   (e) `--set vehicle.cr_vehicle_id=2 --set planning.replanning_frequency=1`:
   the BMW 320i parameters, one cycle per step;
   (f) the highway's wall per cycle with the logs and with `--no-logging`,
   two runs each, and the evaluation's seconds per scenario.
   The logger of the first `main` in a process is kept: later calls write to
   its messages.log.

16. Wale-Net prediction on a synthetic export (the real weights are not in
   the repository; `workloads.write_synthetic_walenet_onnx` at the recorded
   widths: `sc_conv1` 32 x 1 x 3 x 3 on the full 256 x 256 raster, the rest
   guessed; the predictions mean nothing physically):
   (a) the graph written under build/;
   (b) at B = 1, 8 and 16, every node of the graph on the card in float32
   (TF32 off) fed the CPU float64 interpreter's inputs for it: the ops that
   move or pick values bitwise equal to the float64 value rounded to
   float32, the rest and the whole net within 1e-4 of the output's scale;
   (c) per call at B = 1, 8 and 16: the net's device time (CUDA events), its
   host-clock wall, the preprocessing (raster + neighbour grid) and the
   whole `predict`;
   (d) the convoy (A = 8) in walenet mode on the host sequential, host
   batched and device hybrid paths: equal statuses and steps, device
   positions within 1e-4 m of the sequential run, the batched run's within
   1e-4 m of it up to the first retirement; one fetch per cycle + 1;
   (e) a walenet fleet of two (highway, overtake), members one after
   another, each equal to its solo run;
   (f) `highway --prediction walenet --evaluate` through the CLI;
   (g) a missing export raises FileNotFoundError.

17. the torch.distributed mesh, in this process joined to a world of
   one rank under NCCL (`parallel.distributed.initialize` over a file store
   under build/; the group is destroyed at the end):
   (a) the backend, `process_info() == (0, 1)`, `default_device()` the
   rank's card;
   (b) `parallel.mesh.sharded_full_cycle` on phase 6's stacked problem
   (A = 8, M = 1024, float32): every output and `poses_all` bitwise equal
   to `batched_full_cycle` on the card, one K1 launch per call; p50 of both
   in turns (batched, sharded, sharded, batched) and of the all-gather
   alone (`gather_rows`, a real NCCL call at W = 1), beside phase 6's p50;
   (c) `DeviceSimulation(convoy A = 8, mesh)` eager and replayed with the
   NCCL all-gather captured in the CUDA graph (sync debug mode "error", one
   fetch, replayed = eager bitwise, K1 = programs x cycles), statuses and
   steps equal to phase 11's unsharded run, positions within 1e-4 m; ms per
   cycle beside phase 11's;
   (d) `run_fleet(workloads.device_fleet(2), mesh)` equal to the unsharded
   fleet (statuses, steps, trajectories bitwise);
   (e) `graft_entry.entry()` on the card: best_idx equal to the CPU float64
   run's or tied within 4 float32 ulps; `dryrun_multichip(1, "cuda")` in a
   spawned NCCL rank of its own, which reports its K1 launches;
   (f) `highway overtake --workers 2` through the CLI on the card against
   the sequential CLI run: the same score rows up to wall_s; each worker
   reports its K1 launches;
   (g) a rehearsal on the CPU in a 2-rank gloo world of spawned processes:
   (b)'s sharded cycle against the batched cycle, and the overtake (at
   sampling level 1) through `DeviceSimulation(mesh=2 ranks)` against its
   solo run (statuses, steps, positions within 1e-4 m); its wall.  It shows the split and the gather
   across processes, which one card cannot show under NCCL (two NCCL ranks
   cannot share a card); its ranks run K1's plain twin on the CPU, so it
   counts no launch and is not a card path.

18. plots (`utils.visualization`, `risk.visualization`):
   (a) whether matplotlib and PIL import here, with their versions;
   (b) phase 8's risk cycle on the card in float32: the arrays that
   plot_scenario_at_timestep, risk_dashboard and plot_scenario_risk draw,
   fetched as they fetch them (one device-to-host copy per picture), against
   the same cycle's CPU float64 arrays: best_idx equal or tied, selectable
   equal outside a tie, positions within 1e-4 m, total risk within 1e-4; ms
   per fetch;
   (c) without matplotlib (the card's machine has none): `run_one` with a
   log directory and save_plots, and `run_scenario.main` with `--device-sim
   --plot`, `--plot --gif` and `--workers 2 --plot` on highway and overtake
   each fail with ImportError naming matplotlib before any K1 launch (the
   workers report 0), with their rows in log_failures.csv;
   (d) with matplotlib: `highway --plot --gif` on the card writes the frame
   names of phase 15's CPU float64 run, final.png and run.gif, and launches
   K1 as its unplotted twin; render ms per frame and the plotted run's ms
   per cycle beside phase 15's `--no-logging` run.

19. the JAX package's surface on the port:
   (a) every name the JAX subpackages re-export imports from the port's
   subpackages (and neither JAX nor the JAX package is loaded);
   (b) `planner.initial_state.compute_initial_state` for 8 agents in float32
   and float64: one K1 launch per call on the stacked (8·R, 3) table, held
   against the port's CPU float64 result (float64 within 1e-10, float32
   within INIT_F32_RTOL per column) and `compute_initial_state_np`;
   (c) the s_curve (no behavior), double_lane_change and double_crossing
   (behavior) families at their default size: float64 on the card equal to
   the CPU float64 run (statuses, steps, the steps of the reference-path
   rebuilds, positions within 1e-6 m), float32 held against the CPU float32
   run as in 13 (a);
   (d) `run_scenario highway --cpu` in a process of its own: exit 0, no K1
   launch and no CUDA context.

20. compiled host paths (`utils.compiled`: every program the JAX package
   jits on its host paths is a CUDA graph captured once per signature and
   replayed; phases 4 to 19 already run them so).  Each path runs eager
   (`disable_compiled()`), then compiled twice (the first run captures, the
   second replays only), at capped steps in float32: (a) the dense cycle;
   (b) the highway; (c) the batched convoy A = 8; (d) the min_risk run with
   `log_risk`; (e) the highway with responsibility 0.2, sequential; (f) the
   gated blind spot, sequential; (g) the walenet highway on the synthetic
   export; (h) `sharded_full_cycle` at W = 1 under NCCL.  Each compiled
   result must equal its eager twin bitwise (for (g), where the net's
   predictions under capture differ, the max |Δ| is printed and they must
   lie within 1e-6 relative, with equal statuses, steps and selections),
   with equal K1 launches; printed: captures and capture seconds, ms per
   cycle compiled (the replaying run) against eager.  (i) A compiled body
   that calls `.item()` must raise at its capture.

21. (run after phase 8) kernel Q, the risk stack's collision-probability
   quadrature, at the convoy cells' shape (A = 8, M = 1,024, O = 16,
   t = 30) in two settings: near (obstacles 7-18 m ahead and slower, others
   at -25..-8 or 20-45 m: 2.6 % of the cells inside the 5 m gate of a valid
   slot) and open (at most one obstacle, 25-50 m ahead and faster: none).
   In float32 and float64 Q against the plain twin on the card: +0.0 on
   every cell it does not price, the twin 0 there, the max |Δ| on the
   priced cells within 1e-6 (float32) / 1e-13 (float64); Q's device time
   alone and with the wrapper's preparation, its bound (the larger of its
   bytes at 3.35 TB/s, the priced cells' operations at 67 TFLOP/s and the
   launch floor of phase 3) and the twin's time.  Then the batched convoy
   path (phase 9's batched cycle with responsibility) launches Q once per
   call, compiled and replaying.

22. (run after phase 21) kernel K2, the rollout (K2a -> K1 -> K2b): (a)
   bitwise against its plain twin at the dense, batched and device-run
   shapes, float32 and float64; (b) its time, the twin's and its bytes
   bound; (c) on every main path one K2 launch pair per rollout, and one K3
   launch per K2 pair; (d) kernels per replay with the twin and with K2.
23. (run after phase 22) kernel K3, the stages after the rollout: (a) at
   the dense, batched and device-run shapes against the plain stages:
   flags, steps, harms and the jerk terms bitwise, the summed terms within
   1e-5 (float32) / 1e-12 (float64) of their size; (b) its time, the plain
   stages' and its bytes bound; (c) phase 22's launch counts; (d) kernels
   per replay of the dense, batched and device-run programs with the plain
   stages and with K3.

Each path on the card (phases 4 to 20) is driven with K1's launch count set
to 0 just before and read just after (spawned ranks and workers report
their own counts); a path that launched no kernel fails the run.
Then the kernels' JSON line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises, and the script exits
non-zero without printing the last line.  It needs no network and starts
no process that outlives it (nvcc and nvidia-smi run to completion).
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import logging
import math
import os
import sqlite3
import subprocess
import sys
import tempfile
import time
import typing

import numpy as np
import torch

from frenetix_tpu_torch.behavior import behavior_module
from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.io.commonroad import Obstacle, State
from frenetix_tpu_torch.models import onnx_torch, walenet
from frenetix_tpu_torch.models.onnx_lite import OnnxGraph, load_onnx
from frenetix_tpu_torch.ops import _kernels, table_interp
from frenetix_tpu_torch.ops.kinematics import rollout_candidates
from frenetix_tpu_torch.parallel import device_sim
from frenetix_tpu_torch.parallel.mesh import batched_full_cycle
from frenetix_tpu_torch.planner import reactive
from frenetix_tpu_torch.planner.core import cycle_stages as _CYCLE_STAGES, evaluate_cycle
from frenetix_tpu_torch.risk import reachable_set
from frenetix_tpu_torch.risk.costs import trajectory_risks
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch import run_scenario
from frenetix_tpu_torch.ops.vehicle_db import resolve_vehicle
from frenetix_tpu_torch.run_scenario import run_scenarios
from frenetix_tpu_torch.sim import visible_area
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import load_config
from frenetix_tpu_torch.utils import compiled, tracing, visualization
from frenetix_tpu_torch.utils.parting import (
    CycleTrace, RunTrace, classify_parting, classify_run_parting, first_parting,
    first_run_parting, stopping_flips,
)
from frenetix_tpu_torch.utils.sim_logging import require_strict_tables
from frenetix_tpu_torch.workloads import (
    dense_cycle_problem, device_fleet, initial_state_problem, stacked_cycle_problem,
    stacked_post_pass_extras, write_synthetic_walenet_onnx,
)

KERNEL_SOURCE = "frenetix_tpu_torch/csrc/table_interp.cu"
REPLACES = "frenetix_tpu/ops/pallas_interp.py:34"
R_ROWS, C_COLS, P_DENSE = 868, 7, 1_079_296
P_SIM = 1024 * 31      # level-2 sampling of the simulations, padded
A_BATCH, M_BATCH = 8, 1024
O_SLOTS = 16           # obstacle slots of the simulations' prediction tensors
ULPS = 4
POS_TOL = 1e-4         # metres: device-resident run against the host run, float32
BEH_POS_TOL = 1e-6     # metres: behavior runs against each other, float64
# metres: a float32 run on the card against the port's float32 run on the CPU
# before they part (the multi-agent runs of phase 7 ended bitwise equal in
# the chip run that set it, NVIDIA H100 80GB HBM3, 700.00 W)
F32_CPU_TOL = 1e-6
# float32 ulps of the best cost: a fleet member's selection margins against
# its solo run's (the padded fleet sums the cost terms in another order)
F32_MARGIN_ULPS = 64
FLEET_SIZES = (1, 8, 32)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # float32 outside the tensor cores


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def _same_or_tie(best, best64, cost64, what):
    """`best` (card, float32) must be the CPU float64 selection or tie with it
    within ULPS float32 ulps of the float64 cost; returns 1 for a tie."""
    if best == best64:
        return 0
    gap = abs(cost64[best] - cost64[best64])
    bound = ULPS * float(np.spacing(np.float32(abs(cost64[best64]))))
    check(gap <= bound, f"{what}: best {best} (cuda f32) vs {best64} (cpu f64): "
                        f"cost gap {gap} > {bound}")
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


def cuda_ms(fn, reps, batches=5):
    """Device ms per call, with CUDA events, after warm-up: the median over
    `batches` batches of the mean of `reps` back-to-back calls.  Each batch
    is queued behind a ~25 ms spin kernel, so the host has enqueued all of
    it before the first call starts and the events time device work, not
    the host's launch rate (a K1 call takes less device time than its
    Python launch).  The median keeps a batch taken while the clocks still
    ramp up from counting."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    cap = torch.cuda.get_device_capability(dev)
    check(cap[0] == 9, f"{name} is not Hopper (compute capability {cap})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    phase(1, f"device {name}, capability {cap[0]}.{cap[1]}, "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
             f"nvidia-smi: {smi}; TF32 off")
    return dev, name, smi


def phase_build():
    for what, name in (("K1", "table_interp"), ("K2", "rollout"), ("K3", "cycle"),
                       ("Q", "risk_quadrature")):
        t0 = time.perf_counter()
        _kernels.load_library(name)
        info = _kernels.build_info(name)
        phase(2, f"{what} built={info['built']} nvcc_s={info['seconds']:.2f} "
                 f"load_s={time.perf_counter() - t0:.2f} lib={info['library']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  ptxas: {line.strip()}")


def k1_bound_ms(rows, cols, p, itemsize):
    """The least time the card could take for one K1 call: the larger of its
    bytes (table, row indices and factors read once, the (C, P) result
    written once) over the memory rate, and its operations (one subtraction
    per query, two products and one sum per output element) over the
    float32 rate.  Returns (ms, "bytes" or "operations", bytes)."""
    n_bytes = rows * cols * itemsize + p * (4 + itemsize) + cols * p * itemsize
    n_ops = p + 3 * cols * p
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", n_bytes


def host_count(name):
    """The port's host counter `name` (`utils.tracing`; 0 before its first
    count)."""
    return tracing.COUNTERS.get(name, 0)


class Launches:
    """K1's launch count per driven path: the counter's change from just
    before the path to just after; a path that launched no kernel fails."""

    def __init__(self):
        self.by_path = {}
        self.at_start = 0

    def start(self):
        self.at_start = host_count("kernel.k1.launches")

    def stop(self, path, replayed=None):
        """`replayed`: the path's launches as the run reports them
        (`extras["k1_launches"]`), read in place of the counter."""
        launched = host_count("kernel.k1.launches") - self.at_start
        return self.record(path, launched if replayed is None else replayed)

    def record(self, path, n):
        """A path's launches as counted elsewhere (a replayed graph, or a
        spawned process that reports its own count)."""
        check(n > 0, f"{path} launched K1 no time")
        self.by_path[path] = int(n)
        return self.by_path[path]


def grid_sample_inputs(table, gidx, lam):
    """K1's inputs as `torch.nn.functional.grid_sample` takes them: the table
    as a (1, C, 1, R) image and the queries as a (1, 1, P, 2) grid with
    x = 2·(i + λ)/(R − 1) − 1, y = 0.  The nearest single PyTorch call to
    K1's function, not the same function: the coordinate is rounded on the
    way in and out, and a λ outside [0, 1) reads the neighbouring segment
    (or the border) instead of extending segment i."""
    rows, cols = table.shape
    image = table.T.contiguous().reshape(1, cols, 1, rows)
    x = 2.0 * (gidx.to(table.dtype) + lam) / (rows - 1) - 1.0
    grid = torch.stack([x, torch.zeros_like(x)], dim=-1).reshape(1, 1, -1, 2)
    return image, grid


def grid_sample_call(image, grid):
    """One grid_sample call on `grid_sample_inputs`: the (C, P) result."""
    out = torch.nn.functional.grid_sample(image, grid, mode="bilinear",
                                          padding_mode="border", align_corners=True)
    return out.reshape(image.shape[1], -1)


def phase_k1(dev, smi):
    rng = np.random.default_rng(0)
    results = {}
    max_err = 0.0
    table_interp.launch_empty(dev)
    torch.cuda.synchronize()
    floor = cuda_ms(lambda: table_interp.launch_empty(dev), 200, 5)
    phase(3, f"empty kernel, launched as K1 is: {floor:.5f} ms per launch, the floor "
             f"of any K1 call [{smi}]")
    # (rows, columns, queries): the dense cycle, the simulations' cycle, the
    # batched cycle on the stacked table (7 + 2 corridor columns), a ragged P
    shapes = ((R_ROWS, C_COLS, P_DENSE), (R_ROWS, C_COLS, P_SIM),
              (A_BATCH * R_ROWS, C_COLS, A_BATCH * M_BATCH * 31),
              (R_ROWS, C_COLS, 1_000_003))
    main_path = shapes[:3]
    for dtype in (torch.float32, torch.float64):
        for rows, cols, p in shapes:
            reps = 20 if p >= 1_000_000 else 50
            table = torch.as_tensor(rng.normal(size=(rows, cols)) * 50.0,
                                    dtype=dtype, device=dev)
            gidx = torch.as_tensor(np.sort(rng.integers(0, rows - 1, p)),
                                   dtype=torch.int32, device=dev)
            # λ mostly in [0, 1), some extrapolating like out-of-window queries
            lam = torch.as_tensor(rng.uniform(-0.5, 1.5, p), dtype=dtype, device=dev)
            got = table_interp.interp_rows(table, gidx, lam)
            want = table_interp.interp_rows_plain(table, gidx, lam)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"K1 differs from its plain twin ({dtype}, P={p}): max |Δ| {err}")
            ms = cuda_ms(lambda: table_interp.interp_rows(table, gidx, lam), reps, 3)
            plain_ms = cuda_ms(
                lambda: table_interp.interp_rows_plain(table, gidx, lam), reps, 3)
            bound, by, n_bytes = k1_bound_ms(rows, cols, p, table.element_size())
            with_floor = max(bound, floor)
            results[(dtype, rows, p)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, bytes=n_bytes,
                launch_floor_ms=floor, bound_with_floor_ms=with_floor)
            phase(3, f"K1 {str(dtype).split('.')[-1]} R={rows} P={p}: bitwise "
                     f"equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                     f"{bound:.4f} ms by {by} ({n_bytes / 1e6:.2f} MB at 3.35 TB/s), "
                     f"max(bound, launch floor) {with_floor:.4f} ms = "
                     f"{with_floor / ms:.2f} of the kernel's time [{smi}]")
            if (rows, cols, p) in main_path:
                # the nearest library call, timed as K1 is; its grid is built
                # outside the timed region
                image, grid = grid_sample_inputs(table, gidx, lam)
                lib = grid_sample_call(image, grid)
                inside = (lam >= 0) & (lam < 1)
                lib_err = float((lib - want).abs().max())
                lib_err_inside = float((lib - want)[:, inside].abs().max())
                lib_ms = cuda_ms(lambda: grid_sample_call(image, grid), reps, 3)
                results[(dtype, rows, p)].update(
                    library_ms=lib_ms, library_max_abs_err=lib_err,
                    library_max_abs_err_lambda_in_0_1=lib_err_inside)
                phase(3, f"  grid_sample (bilinear, border, align_corners) "
                         f"{str(dtype).split('.')[-1]} R={rows} P={p}: {lib_ms:.4f} ms "
                         f"= {lib_ms / ms:.2f} x K1; max |Δ| vs the plain twin "
                         f"{lib_err:.3e} over all λ, {lib_err_inside:.3e} where "
                         f"0 <= λ < 1 [{smi}]")
    return results, max_err


def phase_dense_cycle(dev, smi, launches):
    matrix, mask, ctx, dt, n_steps, n_valid = dense_cycle_problem(dev, torch.float32)
    check(matrix.shape == (34816, 13), f"dense matrix shape {tuple(matrix.shape)}")

    def cycle():
        return evaluate_cycle(matrix, mask, ctx, dt=dt, n_steps=n_steps,
                              low_vel_mode=False, check_boundary=True)

    launches.start()
    res = cycle()
    best, found = int(res.best_idx), bool(res.found)
    check(launches.stop("dense cycle") == 1, "the dense cycle launches K1 once")
    check(found, "dense cycle found no selectable candidate")
    cost32 = res.cost.cpu().numpy()
    check(np.isfinite(cost32[mask.cpu().numpy()]).all(), "non-finite costs")
    check(np.isfinite(res.rollout.x.cpu().numpy()).all(), "non-finite positions")

    m64, k64, c64, *_ = dense_cycle_problem(torch.device("cpu"), torch.float64)
    ref = evaluate_cycle(m64, k64, c64, dt=dt, n_steps=n_steps, low_vel_mode=False,
                         check_boundary=True)
    best64 = int(ref.best_idx)
    cost64 = ref.cost.numpy()
    _same_or_tie(best, best64, cost64, "dense cycle")
    x_err = float(np.abs(res.rollout.x.cpu().numpy().astype(np.float64)
                         - ref.rollout.x.numpy())[mask.cpu().numpy()].max())

    times = []
    for _ in range(3):
        cycle()
    torch.cuda.synchronize()
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cycle()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    p50 = float(np.median(times))
    phase(4, f"dense cycle M={matrix.shape[0]} valid={n_valid} found={found} "
             f"best_idx={best} (cpu f64: {best64}) max|Δx| vs f64 {x_err:.3e} m; "
             f"p50 {p50:.3f} ms over 20 calls (min {min(times):.3f}, "
             f"max {max(times):.3f}), {n_valid / (p50 / 1e3):.4g} valid "
             f"candidate evals/s [{smi}]")
    return p50


def phase_simulation(dev, smi, launches):
    config = load_config()
    config.dtype = "float32"
    launches.start()
    t0 = time.perf_counter()
    results = run_scenarios(["highway", "overtake"], config, dev)
    wall = time.perf_counter() - t0
    n_launches = launches.stop("single-agent simulations")
    for name, res in results:
        check(res.success, f"{name}: {res.agent_status} {res.agent_messages}")
        pos = np.array([s.position for h in res.histories.values() for s in h])
        check(np.isfinite(pos).all(), f"{name}: non-finite executed positions")
        phase(5, f"{name}: success, steps={res.steps}, cycles="
                 f"{len(res.planning_times)}, wall {res.wall_time:.3f} s [{smi}]")

    config64 = load_config()
    config64.dtype = "float64"
    ref = run_scenarios(["highway", "overtake"], config64, torch.device("cpu"),
                        out=sys.stderr)
    for (name, res), (_, res64) in zip(results, ref):
        a = np.array([s.position for s in next(iter(res.histories.values()))])
        b = np.array([s.position for s in next(iter(res64.histories.values()))])
        n = min(len(a), len(b))
        phase(5, f"{name}: cuda f32 vs cpu f64: steps {res.steps} vs {res64.steps}, "
                 f"max position deviation over the first {n} steps "
                 f"{np.abs(a[:n] - b[:n]).max():.3e} m")
    phase(5, f"simulation wall {wall:.3f} s for both scenarios, "
             f"K1 launches {n_launches}")


def timed_calls(fn, n=20, warm=3):
    """p50 and the extremes of `n` calls in ms, each between two CUDA events
    (host launch time included: an eager cycle is bound by it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


def phase_batched_cycle(dev, smi, launches):
    a_n = A_BATCH
    matrices, masks, ctx, ctxs, dt, n_steps = stacked_cycle_problem(
        a_n, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
    check(matrices.shape == (a_n, M_BATCH, 13), f"matrices {tuple(matrices.shape)}")
    rows = sorted({int(c.ref.s.shape[0]) for c in ctxs})
    check(len(rows) > 1, "the agents' tables should differ in R")
    fn = batched_full_cycle(dt=dt, n_steps=n_steps)

    launches.start()
    out = fn(matrices, masks, ctx)
    check(launches.stop("batched cycle") == 1, "a batched call launches K1 once")
    best = out["best"].cpu().numpy()
    check(bool(out["found"].all()), f"batched cycle: found {out['found'].tolist()}")
    for key in ("x", "y", "v", "cost", "terms"):
        check(bool(torch.isfinite(out[key]).all()), f"batched cycle: non-finite {key}")

    m64, k64, _, ctxs64, _, _ = stacked_cycle_problem(
        a_n, torch.device("cpu"), torch.float64, m_bucket=M_BATCH, spread=12.0,
        ragged=True)
    ties = 0
    for a in range(a_n):
        ref = evaluate_cycle(m64[a], k64[a], ctxs64[a], dt=dt, n_steps=n_steps,
                             low_vel_mode=False)
        b64, cost64 = int(ref.best_idx), ref.cost.numpy()
        ties += _same_or_tie(int(best[a]), b64, cost64, f"batched cycle agent {a}")
        x64 = ref.rollout.x[b64].numpy()
        err = float(np.abs(out["x"][a].cpu().numpy() - x64).max())
        check(int(best[a]) != b64 or err < 1e-2, f"agent {a}: selected x off by {err} m")

    before = host_count("kernel.k1.launches")
    p50, lo, hi = timed_calls(lambda: fn(matrices, masks, ctx))
    check(host_count("kernel.k1.launches") - before == 23, "one K1 launch per batched call")

    def sequential():
        for a in range(a_n):
            r = evaluate_cycle(matrices[a], masks[a], ctxs[a], dt=dt, n_steps=n_steps,
                               low_vel_mode=False)
            torch.index_select(r.rollout.x, 0, r.best_idx.reshape(1).long())

    seq50, seq_lo, seq_hi = timed_calls(sequential)
    phase(6, f"batched cycle A={a_n} M={M_BATCH} R={rows}->{int(ctx.ref.s.shape[1])}: "
             f"best {best.tolist()} equals the cpu f64 sequential cycle "
             f"({ties} ties within {ULPS} float32 ulps); 1 K1 launch per call; p50 "
             f"{p50:.3f} ms over 20 calls (min {lo:.3f}, max {hi:.3f}), "
             f"{p50 / a_n:.3f} ms per agent; {a_n} sequential cycles p50 {seq50:.3f} ms "
             f"(min {seq_lo:.3f}, max {seq_hi:.3f}), {seq50 / a_n:.3f} ms per agent; "
             f"sequential/batched {seq50 / p50:.2f} [{smi}]")
    return p50


def _multiagent_run(family, dev, dtype, batched):
    config = load_config()
    config.dtype = dtype
    config.simulation.start_multiagent = True
    config.simulation.batched_device_agents = batched
    scenario = getattr(scenario_factory, f"make_{family}")()
    sim = Simulation(scenario, config, dev)
    res = sim.run()
    return sim, res


def _end_positions(res):
    return {aid: np.asarray(h[-1].position, dtype=np.float64)
            for aid, h in res.histories.items()}


def phase_multiagent(dev, smi, launches):
    """Returns {family: (batched result, sequential result)} of the runs on
    the card, which phase 11 holds the device-resident run against."""
    runs = {}
    for family, n_agents in (("convoy", 8), ("highway", 2)):
        launches.start()
        sim, res = _multiagent_run(family, dev, "float32", batched=True)
        n_launches = launches.stop(f"multi-agent {family}, batched")
        check(len(sim.agents) == n_agents, f"{family}: {len(sim.agents)} agents")
        check(res.success, f"{family} batched: {res.agent_status} {res.agent_messages}")
        pos = np.array([s.position for h in res.histories.values() for s in h])
        check(np.isfinite(pos).all(), f"{family}: non-finite executed positions")
        batches = [b for a in sim.agents for b in a.record.batch_planning_times]
        check(batches, f"{family}: no batched pass was recorded")
        passes = sum(1.0 / n for _, n in batches)
        phase(7, f"{family} batched on the card: {n_agents} agents "
                 f"COMPLETED_SUCCESS, steps={res.steps}, batched passes "
                 f"{passes:.0f}, K1 launches {n_launches}, wall {res.wall_time:.3f} s, "
                 f"mean batched pass "
                 f"{1e3 * float(np.mean([t for t, _ in batches])):.3f} ms [{smi}]")

        launches.start()
        _, seq = _multiagent_run(family, dev, "float32", batched=False)
        seq_launches = launches.stop(f"multi-agent {family}, sequential")
        check(seq.agent_status == res.agent_status and seq.steps == res.steps,
              f"{family}: sequential on the card {seq.agent_status} steps {seq.steps} "
              f"vs batched {res.agent_status} steps {res.steps}")
        # the port's float32 on the CPU: the same planner in the same
        # precision (its float64 gap is held against JAX's float64 by the
        # CPU tests), so the card must take its steps
        _, ref = _multiagent_run(family, torch.device("cpu"), "float32", batched=True)
        end, end_seq, end_ref = (_end_positions(r) for r in (res, seq, ref))
        dev_seq = max(float(np.abs(end[a] - end_seq[a]).max()) for a in end)
        dev_ref = max(float(np.abs(end[a] - end_ref[a]).max()) for a in end)
        check(_statuses(ref) == _statuses(res) and ref.steps == res.steps,
              f"{family}: cpu f32 batched {ref.agent_status} steps {ref.steps} vs the "
              f"card's {res.agent_status} steps {res.steps}")
        check(dev_ref <= F32_CPU_TOL, f"{family}: card f32 end positions {dev_ref} m from "
                                      f"cpu f32 (limit {F32_CPU_TOL})")
        phase(7, f"{family}: sequential on the card: equal statuses and steps "
                 f"({seq.steps}), K1 launches {seq_launches}, wall "
                 f"{seq.wall_time:.3f} s, max end-position deviation {dev_seq:.3e} m; "
                 f"cpu f32 batched: equal statuses and steps ({ref.steps}), max "
                 f"end-position deviation {dev_ref:.3e} m (limit {F32_CPU_TOL}) [{smi}]")
        runs[family] = (res, seq)
    return runs


def _risk_cycle_problem(device, dtype):
    """A simulation-sized cycle with risk in it: the stacked problem's first
    agent (M = 1024, 4 obstacles), with the obstacles moved onto the agent's
    path so that the risks are not all 0.  Returns (matrix, mask, context
    with the moved obstacles, dt, n_steps)."""
    matrices, masks, _, ctxs, dt, n_steps = stacked_cycle_problem(
        1, device, dtype, m_bucket=M_BATCH, spread=12.0)
    ctx = ctxs[0]
    means = ctx.preds.means.clone()
    means[..., 0] = torch.tensor([52.0, 58.0, 64.0, 70.0], dtype=dtype,
                                 device=device)[:, None]
    means[..., 1] = torch.tensor([9.0, 11.5, 14.0, 17.5], dtype=dtype,
                                 device=device)[:, None]
    return matrices[0], masks[0], ctx._replace(preds=ctx.preds._replace(means=means)), \
        dt, n_steps


def _risk_problem(device, dtype):
    """The rollout and the risk stack of `_risk_cycle_problem`."""
    matrix, _, ctx, dt, n_steps = _risk_cycle_problem(device, dtype)
    preds = ctx.preds

    def rollout():
        return rollout_candidates(
            matrix, ctx.ref, ctx.veh, dt=dt, n_steps=n_steps, low_vel_mode=False,
            x0_orientation=ctx.x0_orientation, table_window=768)

    def risks(ro):
        return trajectory_risks(ro, preds, meta_from_footprint(
            preds.lengths, preds.widths), ctx.veh.mass)

    return rollout, risks


def _min_risk_run(scenario, dev, launches, path):
    """One simulation with emergency_mode = "min_risk" and log_risk; returns
    (result, planner modes per cycle, logged ego risks, K1 launches)."""
    config = load_config()
    config.dtype = "float32"
    config.planning.emergency_mode = "min_risk"
    config.debug.log_risk = True
    cycles = []
    plan_fn = reactive.ReactivePlanner.plan

    def recording_plan(self, x0, x_cl):
        plan = plan_fn(self, x0, x_cl)
        cycles.append((None, None) if plan is None else (plan.mode, plan.ego_risk))
        return plan

    reactive.ReactivePlanner.plan = recording_plan
    try:
        launches.start()
        res = Simulation(scenario, config, dev).run()
        n_launches = launches.stop(path)
    finally:
        reactive.ReactivePlanner.plan = plan_fn
    modes = [mode for mode, _ in cycles]
    logged = [risk for _, risk in cycles if risk is not None]
    return res, modes, logged, n_launches


def phase_risk(dev, smi, launches):
    rollout, risks = _risk_problem(dev, torch.float32)
    launches.start()
    ro = rollout()
    launches.stop("risk rollout")
    torch.cuda.reset_peak_memory_stats()
    got = risks(ro)
    peak = torch.cuda.max_memory_allocated() / 2**20
    risk_ms, _, _ = timed_calls(lambda: risks(ro), n=10, warm=1)
    rollout64, risks64 = _risk_problem(torch.device("cpu"), torch.float64)
    want = risks64(rollout64())
    errs = {}
    for f in ("ego_risk", "obst_risk", "coll_prob_per_obst"):
        g = getattr(got, f).cpu().numpy().astype(np.float64)
        check(np.isfinite(g).all(), f"trajectory_risks: non-finite {f}")
        errs[f] = float(np.abs(g - getattr(want, f).numpy()).max())
        check(errs[f] <= 1e-4, f"trajectory_risks {f}: max |Δ| {errs[f]} > 1e-4")
    check(float(want.ego_risk.max()) > 1e-3, "the risk problem has no risk in it")
    phase(8, f"trajectory_risks M={M_BATCH} O=4 on the card f32 vs cpu f64: max |Δ| "
             + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
             + f" (limit 1e-4); max ego_risk {float(want.ego_risk.max()):.4f}; "
             f"p50 {risk_ms:.3f} ms, peak memory {peak:.1f} MiB [{smi}]")

    # scenarios in which no candidate is selectable in some cycle: a standing
    # vehicle 14 m ahead of an ego at 15 m/s (no candidate avoids it, so every
    # cycle is a min_risk cycle until the crash), and the overtake family
    # with a crawling lead on lanes too narrow to pass freely
    total = 0
    for path, scenario in (
            ("min_risk, standing lead", scenario_factory.make_highway(
                lead_v=0.0, lead_gap=14.0)),
            ("min_risk, narrow overtake", scenario_factory.make_overtake(
                lane_width=2.4, lead_v=1.0, lead_gap=22.0))):
        res, modes, logged, n_launches = _min_risk_run(scenario, dev, launches, path)
        n_min_risk = modes.count("min_risk")
        total += n_min_risk
        check(logged and np.isfinite(logged).all(),
              f"{path}: log_risk recorded no finite risk")
        phase(8, f"{path} on the card: {len(modes)} cycles, {n_min_risk} min_risk "
                 f"cycles, statuses "
                 f"{ {k: v.name for k, v in res.agent_status.items()} }, steps "
                 f"{res.steps}, max logged ego_risk {max(logged):.4f}, K1 launches "
                 f"{n_launches}, wall {res.wall_time:.3f} s [{smi}]")
    check(total > 0, "no cycle ran the min_risk branch on the card")


def _responsibility_sim(dev, dtype, batched=False):
    config = load_config()
    config.dtype = dtype
    config.simulation.start_multiagent = True
    config.simulation.batched_device_agents = batched
    config.cost_weights["responsibility"] = 0.2
    return Simulation(scenario_factory.make_highway(), config, dev)


def _responsibility_run(dev, dtype, batched, max_steps=None):
    sim = _responsibility_sim(dev, dtype, batched)
    if max_steps is not None:
        sim.max_steps = max_steps
    return sim, sim.run()


def phase_responsibility(dev, smi, launches, plain_p50):
    launches.start()
    sim, res = _responsibility_run(dev, "float32", batched=True)
    n_batched = launches.stop("responsibility highway, batched")
    check(len(sim.agents) == 2, f"responsibility: {len(sim.agents)} agents")
    check(res.success, f"responsibility batched: {res.agent_status} {res.agent_messages}")
    batches = [b for a in sim.agents for b in a.record.batch_planning_times]
    check(batches, "responsibility: no batched pass was recorded")
    launches.start()
    _, seq = _responsibility_run(dev, "float32", batched=False)
    n_seq = launches.stop("responsibility highway, sequential")
    check(seq.agent_status == res.agent_status and seq.steps == res.steps,
          f"responsibility: sequential {seq.agent_status} steps {seq.steps} vs "
          f"batched {res.agent_status} steps {res.steps}")
    end, end_seq = _end_positions(res), _end_positions(seq)
    dev_seq = max(float(np.abs(end[a] - end_seq[a]).max()) for a in end)
    # the CPU float64 run costs seconds per cycle (the risk stack at 16
    # obstacle slots): its first two cycles only
    ref_steps = 6
    _, ref = _responsibility_run(torch.device("cpu"), "float64", batched=True,
                                 max_steps=ref_steps)
    dev_ref = max(float(np.abs(np.asarray(res.histories[a][ref_steps].position)
                               - np.asarray(ref.histories[a][ref_steps].position)).max())
                  for a in res.histories)
    check(np.isfinite([dev_seq, dev_ref]).all(), "responsibility: non-finite positions")
    phase(9, f"highway, responsibility 0.2, 2 agents on the card: batched "
             f"COMPLETED_SUCCESS steps={res.steps} wall {res.wall_time:.3f} s, mean "
             f"batched pass {1e3 * float(np.mean([t for t, _ in batches])):.3f} ms, K1 "
             f"launches {n_batched}; sequential equal statuses and steps, wall "
             f"{seq.wall_time:.3f} s, K1 launches {n_seq}, max end-position deviation "
             f"{dev_seq:.3e} m; cpu f64 batched after {ref_steps} steps: max position "
             f"deviation {dev_ref:.3e} m [{smi}]")

    # one batched cycle with the term, on phase 6's problem at 16 slots
    w = 0.3
    matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
        A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True,
        o_slots=O_SLOTS)
    check(ctx.preds.means.shape[:2] == (A_BATCH, O_SLOTS), "obstacle slots")
    grid, _, _ = stacked_post_pass_extras(ctx)
    fn = batched_full_cycle(dt=dt, n_steps=n_steps, resp_weight=w)
    plain = batched_full_cycle(dt=dt, n_steps=n_steps)
    launches.start()
    out = fn(matrices, masks, ctx, grid)
    check(launches.stop("batched cycle with responsibility") == 1,
          "a batched call launches K1 once")
    check(bool(out["found"].all()), f"responsibility cycle: found {out['found'].tolist()}")
    check(bool(torch.isfinite(out["cost"]).all()), "responsibility cycle: non-finite cost")
    base = plain(matrices, masks, ctx)
    moved = float((out["cost"] - base["cost"]).abs().max())

    # the CPU float64 reference on the 4 real obstacle slots (the 12 padded
    # slots are invalid and add exact zeros)
    m64, k64, c64, _, _, _ = stacked_cycle_problem(
        A_BATCH, torch.device("cpu"), torch.float64, m_bucket=M_BATCH, spread=12.0,
        ragged=True, o_slots=4)
    g64, _, _ = stacked_post_pass_extras(c64)
    res64 = evaluate_cycle(m64, k64, c64, dt=dt, n_steps=n_steps, low_vel_mode=False)
    risks64 = trajectory_risks(res64.rollout, c64.preds, meta_from_footprint(
        c64.preds.lengths, c64.preds.widths), c64.veh.mass)
    cost64 = (res64.cost + w * reachable_set.responsibility_reach_grid(
        res64.rollout, g64, risks64, dt)).numpy()
    sel64 = res64.selectable.numpy()
    spread = max(float(np.ptp((cost64[a] - res64.cost[a].numpy())[sel64[a]]))
                 for a in range(A_BATCH))
    check(spread > 0.0, "the responsibility term is the same for every candidate")
    best = out["best"].cpu().numpy()
    ties = 0
    for a in range(A_BATCH):
        b64 = int(np.argmin(np.where(sel64[a], cost64[a], np.inf)))
        ties += _same_or_tie(int(best[a]), b64, cost64[a], f"responsibility agent {a}")
    p50, lo, hi = timed_calls(lambda: fn(matrices, masks, ctx, grid))
    base50, _, _ = timed_calls(lambda: plain(matrices, masks, ctx))
    phase(9, f"batched cycle with responsibility {w} A={A_BATCH} M={M_BATCH} "
             f"O={O_SLOTS}: best {best.tolist()} equals cpu f64 ({ties} ties within "
             f"{ULPS} float32 ulps), the term spreads {spread:.3e} over the selectable "
             f"candidates and moves the selected cost by up to {moved:.3e}; p50 "
             f"{p50:.3f} ms over 20 calls (min {lo:.3f}, max {hi:.3f}); the same cycle "
             f"without the term p50 {base50:.3f} ms (phase 6, 4 slots: "
             f"{plain_p50:.3f} ms); with/without {p50 / base50:.2f} [{smi}]")
    return seq


def _blind_spot():
    """A truck parked beside the lane hides what is behind it."""
    scenario = scenario_factory.make_highway(ego_v=13.0, lead_v=13.0, lead_gap=120.0,
                                             n_steps=150)
    scenario.obstacles[200] = Obstacle(
        obstacle_id=200, obstacle_type="truck", role="static", length=9.0, width=2.5,
        initial_state=State(0, np.array([60.0, 2.6]), 0.0, 0.0))
    return scenario


def _blind_spot_sim(dev, module_on, batched=False):
    config = load_config()
    config.dtype = "float32"
    config.simulation.start_multiagent = True
    config.simulation.batched_device_agents = batched
    if module_on:
        config.occlusion.use_occlusion_module = True
        config.occlusion.harm_threshold = 0.02
        config.external_cost_weights["occ_um"] = 2.0
        config.external_cost_weights["occ_ve"] = 0.5
        config.prediction.calc_occlusions = True
    return Simulation(_blind_spot(), config, dev)


def _blind_spot_run(dev, module_on, batched):
    sim = _blind_spot_sim(dev, module_on, batched)
    res = sim.run()
    ego = next(iter(sim.scenario.planning_problems))
    passing = [s.velocity for s in res.histories[ego] if 45.0 < s.position[0] < 65.0]
    return sim, res, float(np.mean(passing))


def phase_occlusion(dev, smi, launches):
    launches.start()
    sim, res, v_on = _blind_spot_run(dev, module_on=True, batched=True)
    n_batched = launches.stop("blind spot with the occlusion module, batched")
    check(len(sim.agents) == 2, f"blind spot: {len(sim.agents)} agents")
    check(res.success, f"blind spot batched: {res.agent_status} {res.agent_messages}")
    launches.start()
    seq_sim, seq, v_seq = _blind_spot_run(dev, module_on=True, batched=False)
    n_seq = launches.stop("blind spot with the occlusion module, sequential")
    check(seq.agent_status == res.agent_status,
          f"blind spot: sequential {seq.agent_status} vs batched {res.agent_status}")
    # the ego's run must be the same in both modes.  The other agent's may
    # differ after the ego has reached its goal: the batched step retires a
    # finished agent before it builds the others' predictions, the
    # sequential loop one step later (as in the JAX package)
    ego = next(iter(sim.scenario.planning_problems))
    h, h_seq = res.histories[ego], seq.histories[ego]
    check(len(h) == len(h_seq), f"blind spot: the ego ran {len(h)} steps batched, "
                                f"{len(h_seq)} sequential")
    dev_seq = max(float(np.abs(np.asarray(a.position) - np.asarray(b.position)).max())
                  for a, b in zip(h, h_seq))
    check(dev_seq <= 1e-3, f"blind spot: the ego's batched and sequential runs are "
                           f"{dev_seq} m apart")
    stats = {k: sum(a.planner.gate_stats[k] for a in seq_sim.agents)
             for k in ("levels", "changed", "rejected_all")}
    check(stats["changed"] > 0, f"the gate never removed a first choice: {stats}")
    launches.start()
    _, off, v_off = _blind_spot_run(dev, module_on=False, batched=True)
    launches.stop("blind spot without the module")
    check(off.success, f"blind spot, module off: {off.agent_status}")
    check(v_on < 0.7 * v_off,
          f"the module does not slow the ego enough: {v_on} vs {v_off} m/s")
    phase(10, f"blind spot, module on (occ_um 2.0, occ_ve 0.5, calc_occlusions), 2 "
              f"agents on the card: batched COMPLETED_SUCCESS steps={res.steps} wall "
              f"{res.wall_time:.3f} s, K1 launches {n_batched}; sequential equal "
              f"statuses, steps={seq.steps}, wall {seq.wall_time:.3f} s, K1 launches "
              f"{n_seq}, the ego's {len(h)} states at most {dev_seq:.3e} m apart; "
              f"gated levels "
              f"{stats['levels']}, first choice removed in {stats['changed']}, every "
              f"candidate rejected in {stats['rejected_all']}; mean speed past the "
              f"truck {v_on:.3f} m/s (sequential {v_seq:.3f}) against {v_off:.3f} m/s "
              f"with the module off: {v_on / v_off:.3f}x [{smi}]")

    # the polar ray cast on the card against the host's, 720 rays
    scenario = _blind_spot()
    segs = np.concatenate([
        visible_area.road_boundary_segments(scenario),
        *(visible_area.obstacle_obb_segments(ob.initial_state.position,
                                             ob.initial_state.orientation, ob.length,
                                             ob.width)
          for ob in scenario.obstacles.values())])
    eye = np.array([30.0, 0.3])
    _, want = visible_area.polar_visibility(eye, segs, 50.0, 720)
    errs = {}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-2)):
        got = visible_area.polar_visibility_batch(
            torch.as_tensor(eye, dtype=dtype, device=dev),
            torch.as_tensor(segs[:, 0], dtype=dtype, device=dev),
            torch.as_tensor(segs[:, 1], dtype=dtype, device=dev),
            torch.ones(len(segs), dtype=torch.bool, device=dev), 50.0, 720)
        err = float(np.abs(got.cpu().numpy().astype(np.float64) - want).max())
        check(err <= tol, f"polar_visibility_batch {dtype}: max |Δ| {err} > {tol}")
        errs[str(dtype).split(".")[-1]] = err
    phase(10, f"polar_visibility_batch on the card against the host, 720 rays, "
              f"{len(segs)} segments, {int((want < 50.0).sum())} rays clipped: max |Δ| "
              + ", ".join(f"{k} {v:.3e} m" for k, v in errs.items()) + f" [{smi}]")
    return seq


def _device_sim(family, dev):
    config = load_config()
    config.dtype = "float32"
    config.simulation.start_multiagent = True
    scenario = getattr(scenario_factory, f"make_{family}")()
    return device_sim.DeviceSimulation(Simulation(scenario, config, dev))


def _run_once(ds, graph):
    """One device-resident run under the sync debug mode; checks that it
    made exactly one device-to-host copy."""
    fetches = host_count("device_sim.fetches")
    res = ds.run(graph=graph, sync_debug=True)
    check(host_count("device_sim.fetches") == fetches + 1, "a device-resident run fetches once")
    return res


def _position_gap(dres, host):
    """Largest distance in any coordinate between the device run's executed
    positions and the host run's recorded ones, over every agent and step."""
    gap = 0.0
    for col, aid in enumerate(dres.agent_ids):
        pos = np.array([s.position for s in host.histories[aid][1:]], dtype=np.float64)
        gap = max(gap, float(np.abs(dres.trajectories[:len(pos), col, :2] - pos).max()))
    return gap


def _replayed_and_eager(ds, what, launches, programs):
    """One eager and two replayed runs of `ds` under the sync debug mode,
    each with one fetch: K1's launches must be `programs` x cycles and the
    replayed run must equal the first replayed run and the eager run
    bitwise.  Returns (eager, replayed, first replayed)."""
    launches.start()
    eager = _run_once(ds, graph=False)
    n_eager = launches.stop(f"{what}, eager")
    check(n_eager == eager.extras["k1_launches"] == programs * ds.n_cycles,
          f"{what} eager: {n_eager} K1 launches, expected {programs} programs x "
          f"{ds.n_cycles} cycles")
    launches.start()
    first = _run_once(ds, graph=True)
    launches.stop(f"{what}, replayed", replayed=first.extras["k1_launches"])
    check(first.extras["graph"]
          and first.extras["k1_launches"] == programs * ds.n_cycles,
          f"{what} replayed: {first.extras['k1_launches']} K1 launches, expected "
          f"{programs} programs x {ds.n_cycles} cycles")
    replayed = _run_once(ds, graph=True)
    for other, label in ((first, "first replayed run"), (eager, "eager run")):
        for name in ("status", "trajectories", "status_per_step", "selections", "found"):
            check(np.array_equal(getattr(replayed, name), getattr(other, name)),
                  f"{what}: {name} of the replayed run differs from the {label}")
    check(np.isfinite(replayed.trajectories[:replayed.steps]).all(),
          f"{what}: non-finite executed states")
    return eager, replayed, first


def phase_device_run(dev, smi, launches, host_runs):
    """Returns {family: (replayed result, ms per cycle replayed, eager)},
    which phase 17 holds the sharded run against."""
    runs = {}
    for family, n_agents in (("convoy", 8), ("highway", 2)):
        host_batched, host = host_runs[family]
        ds = _device_sim(family, dev)
        check(len(ds.agents) == n_agents, f"{family}: {len(ds.agents)} agents")
        programs = 2 * len(ds.levels)            # kinematics modes x levels
        _run_once(ds, graph=False)               # warms the allocator, builds nothing new
        eager, replayed, first = _replayed_and_eager(
            ds, f"device-resident {family}", launches, programs)
        n_eager = eager.extras["k1_launches"]
        check(np.array_equal(replayed.extras["x_cl_cycles"], eager.extras["x_cl_cycles"]),
              f"{family}: replan states of the replayed run differ from the eager run")
        status = {aid: int(s) for aid, s in zip(replayed.agent_ids, replayed.status)}
        check(status == {aid: int(s) for aid, s in host.agent_status.items()}
              and replayed.steps == host.steps,
              f"{family}: device run {status} steps {replayed.steps} vs host sequential "
              f"{host.agent_status} steps {host.steps}")
        gap = _position_gap(replayed, host)
        check(gap <= POS_TOL, f"{family}: device run {gap} m from the host sequential "
                              f"run (limit {POS_TOL})")
        adapted = ds.to_simulation_result(replayed)
        check(adapted.agent_status == host.agent_status and adapted.steps == host.steps,
              f"{family}: adapted result {adapted.agent_status} steps {adapted.steps}")
        c_n = ds.n_cycles
        phase(11, f"{family} device-resident on the card, {n_agents} agents, {c_n} "
                  f"cycles of {programs} programs, no synchronisation in the loop, 1 "
                  f"fetch per run: eager {eager.wall_time:.3f} s = "
                  f"{1e3 * eager.wall_time / c_n:.3f} ms per cycle (K1 launches "
                  f"{n_eager}); replayed {replayed.wall_time:.3f} s = "
                  f"{1e3 * replayed.wall_time / c_n:.3f} ms per cycle (K1 launches "
                  f"{first.extras['k1_launches']} = recorded x replays; first run with "
                  f"warm-up and capture {first.wall_time:.3f} s, capture "
                  f"{first.extras['capture_s']:.3f} s); replayed equals eager bitwise; "
                  f"statuses and steps ({replayed.steps}) equal the host sequential "
                  f"run, positions within {gap:.3e} m (limit {POS_TOL}); host "
                  f"sequential wall {host.wall_time:.3f} s, host batched wall "
                  f"{host_batched.wall_time:.3f} s; host batched / replayed "
                  f"{host_batched.wall_time / replayed.wall_time:.2f} [{smi}]")
        runs[family] = (replayed, 1e3 * replayed.wall_time / c_n,
                        1e3 * eager.wall_time / c_n)
    return runs


def phase_fleet(dev, smi, launches):
    for size in FLEET_SIZES:
        t0 = time.perf_counter()
        sims = device_fleet(size, dev, "float32")
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fetches = host_count("device_sim.fetches")
        launches.start()
        t0 = time.perf_counter()
        results = device_sim.run_fleet(sims, sync_debug=True)
        wall = time.perf_counter() - t0
        n_k1 = results[0].extras["k1_launches"]
        launches.stop(f"fleet S={size}, replayed", replayed=n_k1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(host_count("device_sim.fetches") == fetches + 1, "a fleet run fetches once")
        check(len(results) == size and results[0].extras["fleet_size"] == size,
              f"fleet S={size}: {len(results)} results")
        for i, r in enumerate(results):
            check(np.isfinite(r.trajectories[:r.steps]).all(),
                  f"fleet S={size} member {i}: non-finite executed states")
        done = sum(int((r.status == 2).all()) for r in results)
        note = ""
        if size == 8:
            # every member against its solo run
            gap = 0.0
            for i, (fleet_res, sim) in enumerate(zip(results, sims)):
                solo = sim.run()
                check(np.array_equal(fleet_res.status, solo.status)
                      and fleet_res.steps == solo.steps,
                      f"fleet member {i}: status {fleet_res.status} steps "
                      f"{fleet_res.steps} vs solo {solo.status} steps {solo.steps}")
                n = solo.steps
                gap = max(gap, float(np.abs(
                    fleet_res.trajectories[:n, :, :2].astype(np.float64)
                    - solo.trajectories[:n, :, :2]).max()))
            check(gap <= POS_TOL, f"fleet members {gap} m from their solo runs "
                                  f"(limit {POS_TOL})")
            note = (f"; every member equals its solo run in status and steps, "
                    f"positions within {gap:.3e} m (limit {POS_TOL})")
        a_max = max(len(s.agents) for s in sims)
        c_max = max(s.n_cycles for s in sims)
        phase(12, f"fleet S={size} (a_max {a_max}, {c_max} cycles) on the card, "
                  f"replayed, 1 fetch: wall {wall:.3f} s with warm-up and capture "
                  f"({results[0].extras['capture_s']:.3f} s), {size / wall:.3f} "
                  f"scenarios/s, {1e3 * wall / c_max:.3f} ms per cycle, peak memory "
                  f"{peak:.3f} GiB, K1 launches {n_k1}, members all at their goal "
                  f"{done}/{size}, host set-up of the members {build_s:.3f} s{note} "
                  f"[{smi}]")


def _behavior_sim(family, dev, dtype, device_fsm="auto", batched=False):
    config = load_config()
    config.dtype = dtype
    config.behavior.use_behavior_planner = True
    config.behavior.device_fsm = device_fsm
    config.simulation.start_multiagent = family == "convoy"
    config.simulation.batched_device_agents = batched
    return Simulation(getattr(scenario_factory, f"make_{family}")(), config, dev)


def _history_gap(a, b, steps=None):
    """Largest coordinate distance between two host results' executed
    positions, over every agent and the first `steps` states."""
    gap = 0.0
    for aid, ha in a.histories.items():
        n = min(len(ha), len(b.histories[aid]))
        n = n if steps is None else min(n, steps)
        pa = np.array([s.position for s in ha[:n]], dtype=np.float64)
        pb = np.array([s.position for s in b.histories[aid][:n]], dtype=np.float64)
        gap = max(gap, float(np.abs(pa - pb).max()))
    return gap


def _statuses(res):
    return {aid: int(s) for aid, s in res.agent_status.items()}


def _dres_statuses(dres):
    return {aid: int(s) for aid, s in zip(dres.agent_ids, dres.status)}


def _dres_gap(a, b):
    n = min(a.steps, b.steps)
    return float(np.abs(a.trajectories[:n, :, :2].astype(np.float64)
                        - b.trajectories[:n, :, :2]).max())


def _f32_against_cpu(make_sim, dev, what, launches):
    """`make_sim(device, "float32")` run on the card (its K1 launches
    counted as path `what`) and on the CPU, both traced
    (`utils.parting.CycleTrace`).  Until the first cycle whose selection
    differs the two must agree within F32_CPU_TOL; that cycle must be a
    float32 tie or threshold flip (`classify_parting`).  Without one, equal
    steps and statuses.  Returns (card result, cpu result, parting or None,
    position gap before the parting, `stopping_flips` of the card's and the
    CPU's run)."""
    config = load_config()

    def traced(device, counted):
        with CycleTrace(reactive, behavior_module) as trace:
            if counted:
                launches.start()
            res = make_sim(device, "float32").run()
            if counted:
                launches.stop(what)
        return res, trace

    (card, card_trace), (cpu, cpu_trace) = traced(dev, True), traced(torch.device("cpu"),
                                                                      False)
    check(_statuses(card) == _statuses(cpu),
          f"{what}: card f32 {card.agent_status} vs cpu f32 {cpu.agent_status}")
    level = first_parting(card_trace, cpu_trace)
    if level is None:
        check(card.steps == cpu.steps, f"{what}: card f32 steps {card.steps} vs cpu f32 "
                                       f"{cpu.steps} without a parting cycle")
        parting, gap = None, _history_gap(card, cpu)
    else:
        parting = classify_parting(card_trace, cpu_trace, level, dt=config.planning.dt,
                                   n_steps=config.planning.n_steps)
        check(parting.kind in ("tie", "threshold"),
              f"{what}: card f32 parts from cpu f32 at plan {parting.plan}: "
              f"{parting.detail}")
        # one plan call every replanning_frequency steps until the parting
        gap = _history_gap(card, cpu, steps=config.planning.replanning_frequency
                           * parting.plan + 1)
    check(gap <= F32_CPU_TOL, f"{what}: card f32 {gap} m from cpu f32 before they part")
    flips = [stopping_flips(t, dt=config.planning.dt, n_steps=config.planning.n_steps)
             for t in (card_trace, cpu_trace)]
    return card, cpu, parting, gap, flips


def _parting_text(parting, gap, card, cpu, flips):
    (card_flagged, card_n), (cpu_flagged, cpu_n) = flips
    share = (f"; stopping candidates with an exact end velocity of 0 flagged as "
             f"reversing: card {card_flagged} of {card_n}, cpu {cpu_flagged} of {cpu_n}"
             if card_n or cpu_n else "")
    if parting is None:
        return (f"card f32 = cpu f32 (steps {card.steps}, equal statuses, positions "
                f"within {gap:.3e} m){share}")
    return (f"card f32 {card.steps} steps, cpu f32 {cpu.steps}, equal statuses; they "
            f"part at plan {parting.plan} ({parting.kind}: {parting.detail}), positions "
            f"within {gap:.3e} m before it{share}")


def _live_margins_ulps(dres, k):
    """The run's selection margins in float32 ulps of the best cost, over the
    (cycle, agent) pairs in which the agent ran (a RUNNING status at one of
    the cycle's `k` sub-steps, as `tools/tie_margins.py` filters) and had two
    selectable candidates or more."""
    gap, rel = dres.extras["margin_gap"], dres.extras["margin_rel"]
    c_n, a_n = gap.shape
    sps = np.zeros((c_n * k, a_n), np.int32)
    sps[:len(dres.status_per_step)] = dres.status_per_step
    live = (sps.reshape(c_n, k, a_n) == 1).any(axis=1) & np.isfinite(gap)
    return gap[live] / _ulp_of_best(gap, rel)[live]


def _ulp_of_best(gap, rel):
    """One float32 ulp of the best cost (gap / margin_rel where the gap is
    positive, else of 1)."""
    pos = np.isfinite(gap) & (rel > 0)
    best = np.where(pos, gap / np.where(pos, rel, 1.0), 1.0)
    return np.spacing(np.abs(best).astype(np.float32)).astype(np.float64)


def _device_f32_against_cpu(family, ds, replayed, launches, programs):
    """Phase 13 (c), float32: the card's replayed run (`replayed`, equal to
    its eager run bitwise) against the port's CPU float32 device run of the
    same family, both eager runs traced (`utils.parting.RunTrace`): equal
    statuses, positions within F32_CPU_TOL up to the first cycle whose
    selection differs, that cycle a tie or threshold flip
    (`classify_run_parting`), else equal steps.  Then the replayed run with
    `emit_margins`: bitwise the plain replayed run, one fetch, and at a tie
    the margin within ULPS float32 ulps.  Returns the line's text."""
    config = load_config()
    dt, n_steps, k = config.planning.dt, config.planning.n_steps, ds.k_replan
    what = f"behavior device run {family}"
    cpu_ds = device_sim.DeviceSimulation(_behavior_sim(family, torch.device("cpu"),
                                                       "float32"))
    with RunTrace(device_sim) as cpu_trace:
        cpu = cpu_ds.run(graph=False)
    launches.start()
    with RunTrace(device_sim) as card_trace:
        traced = ds.run(graph=False)
    launches.stop(f"{what}, eager traced")
    for name in ("status", "trajectories", "selections", "found"):
        check(np.array_equal(getattr(traced, name), getattr(replayed, name)),
              f"{what}: the traced eager run's {name} differ from the replayed run")
    check(_dres_statuses(replayed) == _dres_statuses(cpu),
          f"{what}: card f32 {_dres_statuses(replayed)} vs cpu f32 {_dres_statuses(cpu)}")
    hit = first_run_parting(card_trace, cpu_trace)
    parting = None
    if hit is None:
        check(replayed.steps == cpu.steps, f"{what}: card f32 steps {replayed.steps} vs "
                                           f"cpu f32 {cpu.steps} without a parting cycle")
        gap = _dres_gap(replayed, cpu)
        text = f"card f32 = cpu f32 device run (steps {cpu.steps}, no parting)"
    else:
        parting = classify_run_parting(card_trace, cpu_trace, *hit, dt=dt, n_steps=n_steps)
        check(parting.kind in ("tie", "threshold"),
              f"{what}: card f32 parts from the cpu f32 device run at cycle {hit[0]}, "
              f"agent {hit[1]}: {parting.detail}")
        upto = k * hit[0]
        gap = float(np.abs(replayed.trajectories[:upto, :, :2].astype(np.float64)
                           - cpu.trajectories[:upto, :, :2]).max()) if upto else 0.0
        text = (f"card f32 {replayed.steps} steps, cpu f32 device run {cpu.steps}; they "
                f"part at cycle {hit[0]} (step {upto}), agent {hit[1]}: {parting.kind} "
                f"({parting.detail})")
    check(gap <= F32_CPU_TOL, f"{what}: card f32 {gap} m from the cpu f32 device run "
                              f"before they part")
    # the same replayed run with the selection margins: a body of its own
    fetches = host_count("device_sim.fetches")
    launches.start()
    marg = ds.run(graph=True, sync_debug=True, emit_margins=True)
    launches.stop(f"{what}, replayed with margins", replayed=marg.extras["k1_launches"])
    check(host_count("device_sim.fetches") == fetches + 1,
          f"{what}: the margins run fetches once")
    check(marg.extras["k1_launches"] == programs * ds.n_cycles,
          f"{what} with margins: {marg.extras['k1_launches']} K1 launches")
    check(marg.steps == replayed.steps, f"{what}: margins run steps {marg.steps}")
    for name in ("status", "trajectories", "status_per_step", "selections", "found"):
        check(np.array_equal(getattr(marg, name), getattr(replayed, name)),
              f"{what}: {name} of the margins run differ from the plain replayed run")
    if parting is not None and parting.kind == "tie":
        col = marg.agent_ids.index(hit[1])
        gaps, rels = marg.extras["margin_gap"], marg.extras["margin_rel"]
        g, ulp = gaps[hit[0], col], _ulp_of_best(gaps, rels)[hit[0], col]
        check(g <= ULPS * ulp, f"{what}: a tie at cycle {hit[0]} with a margin of "
                               f"{g / ulp:.1f} float32 ulps")
    ulps = _live_margins_ulps(marg, k)
    pos = ulps[ulps > 0]
    smallest = f"{pos.min():.1f} float32 ulps" if len(pos) else "none"
    flips = [stopping_flips(t, dt=dt, n_steps=n_steps) for t in (card_trace, cpu_trace)]
    share = [f"{f} of {n} ({f / n:.3f})" if n else "none" for f, n in flips]
    return (f"{text}; positions within {gap:.3e} m before it; margins run = replayed "
            f"bitwise, 1 fetch: {len(ulps)} live selections, smallest positive margin "
            f"{smallest}, {int((ulps < ULPS).sum())} under {ULPS} ulps "
            f"({int((ulps == 0).sum())} exact duplicates, gap 0); stopping candidates "
            f"with an exact end velocity of 0 flagged as reversing: card {share[0]}, "
            f"cpu {share[1]}")


def _fleet_margins(sims, families, results, launches):
    """Phase 13 (e) with `emit_margins`: the fleet carries every member's
    margins.  The fleet's selections must equal the plain fleet's bitwise;
    a member's margins must equal its solo margins run's (the same inf
    pattern, within F32_MARGIN_ULPS float32 ulps of the best cost) at every
    cycle where the member selects as its solo run does."""
    fetches = host_count("device_sim.fetches")
    launches.start()
    marg = device_sim.run_fleet(sims, sync_debug=True, emit_margins=True)
    launches.stop("behavior fleet S=3 with margins", replayed=marg[0].extras["k1_launches"])
    check(host_count("device_sim.fetches") == fetches + 1,
          "a behavior fleet with margins fetches once")
    compared = total = 0
    worst = 0.0
    for f, member, plain, sim in zip(families, marg, results, sims):
        for name in ("status", "trajectories", "selections", "found"):
            check(np.array_equal(getattr(member, name), getattr(plain, name)),
                  f"behavior fleet with margins, member {f}: {name} differ from the "
                  f"plain fleet")
        solo = sim.run(emit_margins=True)
        same = (np.all(member.selections == solo.selections, axis=-1)
                & (member.found == solo.found))
        gap, sgap = member.extras["margin_gap"], solo.extras["margin_gap"]
        check(np.array_equal(np.isinf(gap[same]), np.isinf(sgap[same])),
              f"behavior fleet member {f}: margins' inf pattern differs from its solo run")
        fin = same & np.isfinite(sgap)
        ulp = np.maximum(_ulp_of_best(gap, member.extras["margin_rel"]),
                         _ulp_of_best(sgap, solo.extras["margin_rel"]))
        diff = np.abs(gap[fin] - sgap[fin]) / ulp[fin]
        check(np.all(diff <= F32_MARGIN_ULPS),
              f"behavior fleet member {f}: margins {diff.max():.1f} float32 ulps from its "
              f"solo run")
        worst = max(worst, float(diff.max()) if len(diff) else 0.0)
        compared += int(same.sum())
        total += same.size
    return (f"with emit_margins the fleet (1 fetch) = the plain fleet bitwise, members' "
            f"margins within {worst:.1f} float32 ulps of their solo runs' at the "
            f"{compared} of {total} (cycle, agent) selections equal to the solo run's")


def phase_behavior(dev, smi, launches):
    cpu = torch.device("cpu")
    # (a) the host path, one agent
    for family in ("traffic_light", "stop_sign", "lane_change"):
        launches.start()
        r64 = _behavior_sim(family, dev, "float64").run()
        launches.stop(f"behavior host {family}, float64")
        ref = _behavior_sim(family, cpu, "float64").run()
        check(r64.success and _statuses(r64) == _statuses(ref) and r64.steps == ref.steps,
              f"behavior {family}: card f64 {r64.agent_status} steps {r64.steps} vs cpu "
              f"f64 {ref.agent_status} steps {ref.steps}")
        gap64 = _history_gap(r64, ref)
        check(gap64 <= BEH_POS_TOL, f"behavior {family}: card f64 {gap64} m from cpu f64")
        r32, c32, parting, gap, flips = _f32_against_cpu(
            lambda d, dtype: _behavior_sim(family, d, dtype), dev,
            f"behavior host {family}, float32", launches)
        gap32 = _history_gap(r32, ref)
        phase(13, f"(a) behavior host {family}: card f64 = cpu f64 (steps {r64.steps}, "
                  f"success, positions within {gap64:.3e} m), wall {r64.wall_time:.3f} s; "
                  f"{_parting_text(parting, gap, r32, c32, flips)}; "
                  f"card f32 gap to cpu f64 over the common steps {gap32:.3e} m [{smi}]")

    # (b) host batched against host sequential, many agents
    host = {}
    for batched in (True, False):
        how = "batched" if batched else "sequential"
        launches.start()
        host[how] = _behavior_sim("convoy", dev, "float32", batched=batched).run()
        launches.stop(f"behavior convoy host {how}")
    b, s = host["batched"], host["sequential"]
    check(_statuses(b) == _statuses(s),
          f"behavior convoy: batched {b.agent_status} vs sequential {s.agent_status}")
    retire = min(len(h) for r in (b, s) for h in r.histories.values())
    gap = _history_gap(b, s, steps=retire)
    check(gap <= POS_TOL, f"behavior convoy: batched {gap} m from sequential up to step "
                          f"{retire} (limit {POS_TOL})")
    phase(13, f"(b) behavior convoy, 8 agents, host on the card f32, statuses "
              f"{sorted(set(_statuses(b).values()))}: batched "
              f"{b.wall_time:.3f} s (steps {b.steps}), sequential {s.wall_time:.3f} s "
              f"(steps {s.steps}), equal statuses, positions within {gap:.3e} m up to "
              f"the first retirement (step {retire - 1}) [{smi}]")

    # (c) the device-resident run with the FSM in the run
    for family in ("traffic_light", "stop_sign", "yield_sign", "crosswalk", "convoy"):
        ds = device_sim.DeviceSimulation(_behavior_sim(family, dev, "float32"))
        check(ds.fsm_in_scan, f"behavior {family}: FSM not in the run ({ds.fsm_reason})")
        programs = 2 * len(ds.levels) + 2        # + the stopping program's two modes
        _run_once(ds, graph=False)
        eager, replayed, first = _replayed_and_eager(
            ds, f"behavior device run {family}", launches, programs)
        check(not replayed.extras.get("bailed"), f"behavior {family} bailed")
        ds64 = device_sim.DeviceSimulation(_behavior_sim(family, dev, "float64"))
        launches.start()
        d64 = ds64.run()
        launches.stop(f"behavior device run {family}, f64",
                      replayed=d64.extras["k1_launches"])
        launches.start()
        hyb = device_sim.DeviceSimulation(
            _behavior_sim(family, dev, "float64", device_fsm="hybrid")).run()
        launches.stop(f"behavior hybrid run {family}, f64",
                      replayed=hyb.extras["k1_launches"])
        launches.start()
        seq = _behavior_sim(family, dev, "float64").run()
        launches.stop(f"behavior host sequential {family}, f64")
        check(_dres_statuses(d64) == _dres_statuses(hyb) == _statuses(seq)
              and d64.steps == hyb.steps == seq.steps,
              f"behavior {family} f64: in-run {_dres_statuses(d64)} steps {d64.steps}, "
              f"hybrid {_dres_statuses(hyb)} steps {hyb.steps}, host {seq.agent_status} "
              f"steps {seq.steps}")
        gap_h, gap_s = _dres_gap(d64, hyb), _position_gap(d64, seq)
        check(max(gap_h, gap_s) <= BEH_POS_TOL,
              f"behavior {family} f64: in-run {gap_h} m from hybrid, {gap_s} m from host")
        gap32 = _dres_gap(replayed, d64)
        f32_text = _device_f32_against_cpu(family, ds, replayed, launches, programs)
        c_n = ds.n_cycles
        phase(13, f"(c) behavior device run {family}, {len(ds.agents)} agents, FSM in the "
                  f"run, {c_n} cycles of {programs} programs, 1 fetch: f32 eager "
                  f"{1e3 * eager.wall_time / c_n:.3f} ms per cycle, replayed "
                  f"{1e3 * replayed.wall_time / c_n:.3f} ms per cycle (capture "
                  f"{first.extras['capture_s']:.3f} s), replayed = eager bitwise; f64: "
                  f"in-run = hybrid = host sequential (steps {d64.steps}, statuses "
                  f"{sorted(set(_dres_statuses(d64).values()))}), positions within "
                  f"{max(gap_h, gap_s):.3e} m; f32 run's statuses "
                  f"{sorted(set(_dres_statuses(replayed).values()))} steps "
                  f"{replayed.steps}, gap to f64 {gap32:.3e} m; f64 replayed "
                  f"{1e3 * d64.wall_time / c_n:.3f} ms per cycle, hybrid "
                  f"{1e3 * hyb.wall_time / c_n:.3f} ms per cycle; f32 against f32: "
                  f"{f32_text} [{smi}]")

    # (d) hybrid: a fallback at construction and a bail at run time
    for family in ("lane_change", "behavior_overtake"):
        ds = device_sim.DeviceSimulation(_behavior_sim(family, dev, "float64"))
        if family == "lane_change":
            check(not ds.fsm_in_scan and "lane changes" in ds.fsm_reason,
                  f"lane_change: {ds.fsm_in_scan} {ds.fsm_reason}")
        else:
            check(ds.fsm_in_scan, f"behavior_overtake: {ds.fsm_reason}")
        launches.start()
        res = ds.run()
        launches.stop(f"behavior hybrid {family}", replayed=res.extras["k1_launches"])
        if family == "behavior_overtake":
            check(res.extras.get("bailed"), "behavior_overtake did not bail")
        forced = device_sim.DeviceSimulation(
            _behavior_sim(family, dev, "float64", device_fsm="hybrid")).run()
        check(_dres_statuses(res) == _dres_statuses(forced) and res.steps == forced.steps,
              f"behavior {family}: {_dres_statuses(res)} steps {res.steps} vs forced "
              f"hybrid {_dres_statuses(forced)} steps {forced.steps}")
        gap = _dres_gap(res, forced)
        check(gap <= BEH_POS_TOL, f"behavior {family}: {gap} m from the forced hybrid run")
        c_n = ds.n_cycles
        phase(13, f"(d) behavior hybrid {family} f64 ("
                  f"{'bailed at run time' if family != 'lane_change' else 'fallback at construction: ' + ds.fsm_reason}"
                  f"): statuses {_dres_statuses(res)} steps {res.steps} = forced hybrid, "
                  f"positions within {gap:.3e} m; {1e3 * forced.wall_time / c_n:.3f} ms "
                  f"per cycle, {forced.extras['fetches']} fetches and "
                  f"{forced.extras['captures']} captures per run ({c_n} cycles, capture "
                  f"{forced.extras['capture_s']:.3f} s) [{smi}]")

    # (e) a behavior fleet
    families = ("traffic_light", "stop_sign", "convoy")
    sims = [device_sim.DeviceSimulation(_behavior_sim(f, dev, "float32"))
            for f in families]
    check(all(s.fsm_in_scan for s in sims), "behavior fleet: FSM not in the run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fetches = host_count("device_sim.fetches")
    launches.start()
    t0 = time.perf_counter()
    results = device_sim.run_fleet(sims, sync_debug=True)
    wall = time.perf_counter() - t0
    launches.stop("behavior fleet S=3", replayed=results[0].extras["k1_launches"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(host_count("device_sim.fetches") == fetches + 1, "a behavior fleet run fetches once")
    gap = 0.0
    for f, fleet_res, sim in zip(families, results, sims):
        solo = sim.run()
        check(np.array_equal(fleet_res.status, solo.status) and fleet_res.steps == solo.steps,
              f"behavior fleet member {f}: {fleet_res.status} steps {fleet_res.steps} vs "
              f"solo {solo.status} steps {solo.steps}")
        gap = max(gap, _dres_gap(fleet_res, solo))
    check(gap <= POS_TOL, f"behavior fleet members {gap} m from their solo runs")
    margin_text = _fleet_margins(sims, families, results, launches)
    c_max = max(s.n_cycles for s in sims)
    phase(13, f"(e) behavior fleet S=3 ({', '.join(families)}), FSM in the run, replayed, "
              f"1 fetch: wall {wall:.3f} s with warm-up and capture "
              f"({results[0].extras['capture_s']:.3f} s), {3 / wall:.3f} scenarios/s, "
              f"{1e3 * wall / c_max:.3f} ms per cycle, peak memory {peak:.3f} GiB; every "
              f"member equals its solo run, positions within {gap:.3e} m; {margin_text} "
              f"[{smi}]")


def phase_device_post(dev, smi, launches, host_resp, host_occ):
    # (a), (b): against phase 9's and phase 10's host sequential runs
    cases = (("highway, responsibility 0.2", lambda: _responsibility_sim(dev, "float32"),
              host_resp),
             ("blind spot, occlusion module + calc_occlusions",
              lambda: _blind_spot_sim(dev, module_on=True), host_occ))
    for what, make, host in cases:
        ds = device_sim.DeviceSimulation(make())
        check(ds.resp_weight or ds.use_occlusion, f"{what}: no post-pass")
        programs = 2 * len(ds.levels)
        eager, replayed, first = _replayed_and_eager(
            ds, f"device-resident {what}", launches, programs)
        status = _dres_statuses(replayed)
        check(status == _statuses(host) and replayed.steps == host.steps,
              f"{what}: device run {status} steps {replayed.steps} vs host sequential "
              f"{host.agent_status} steps {host.steps}")
        gap = _position_gap(replayed, host)
        check(gap <= POS_TOL, f"{what}: device run {gap} m from the host sequential "
                              f"run (limit {POS_TOL})")
        c_n, kept = ds.n_cycles, len(ds._runner.keep)
        nominal = ds.config.prediction.max_obstacles
        phase(14, f"({'a' if ds.resp_weight else 'b'}) {what}, {len(ds.agents)} agents "
                  f"on the card, {c_n} cycles of {programs} programs, no synchronisation "
                  f"in the loop, 1 fetch per run: eager "
                  f"{1e3 * eager.wall_time / c_n:.3f} ms per cycle; replayed "
                  f"{1e3 * replayed.wall_time / c_n:.3f} ms per cycle (capture "
                  f"{first.extras['capture_s']:.3f} s), K1 launches "
                  f"{first.extras['k1_launches']}; replayed = eager bitwise; statuses "
                  f"and steps ({replayed.steps}) equal the host sequential run, "
                  f"positions within {gap:.3e} m (limit {POS_TOL}) [{smi}]")
        phase(14, f"{what}: window slots kept {kept} of {nominal} [{smi}]")
        phase(14, f"{what}: ms per cycle eager {1e3 * eager.wall_time / c_n:.3f}, "
                  f"replayed {1e3 * replayed.wall_time / c_n:.3f} [{smi}]")

    # (c) behavior + responsibility in float64: in the run = hybrid = host
    runs = {}
    for how, device_fsm in (("in-run", "auto"), ("hybrid", "hybrid")):
        sim = _behavior_sim("traffic_light", dev, "float64", device_fsm=device_fsm)
        sim.config.cost_weights["responsibility"] = 0.2
        ds = device_sim.DeviceSimulation(sim)
        check(ds.fsm_in_scan == (how == "in-run"), f"traffic light: {ds.fsm_reason}")
        launches.start()
        runs[how] = ds.run()
        launches.stop(f"behavior + responsibility traffic light, {how}, f64",
                      replayed=runs[how].extras["k1_launches"])
        programs = 2 * len(ds.levels) + 2
        check(runs[how].extras["k1_launches"] == programs * ds.n_cycles,
              f"traffic light {how}: {runs[how].extras['k1_launches']} K1 launches, "
              f"expected {programs} x {ds.n_cycles}")
    sim = _behavior_sim("traffic_light", dev, "float64")
    sim.config.cost_weights["responsibility"] = 0.2
    launches.start()
    seq = sim.run()
    launches.stop("behavior + responsibility traffic light, host sequential, f64")
    d64, hyb = runs["in-run"], runs["hybrid"]
    check(not d64.extras.get("bailed"), "traffic light bailed")
    check(_dres_statuses(d64) == _dres_statuses(hyb) == _statuses(seq)
          and d64.steps == hyb.steps == seq.steps,
          f"traffic light + responsibility f64: in-run {_dres_statuses(d64)} steps "
          f"{d64.steps}, hybrid {_dres_statuses(hyb)} steps {hyb.steps}, host "
          f"{seq.agent_status} steps {seq.steps}")
    gap_h, gap_s = _dres_gap(d64, hyb), _position_gap(d64, seq)
    check(max(gap_h, gap_s) <= BEH_POS_TOL,
          f"traffic light + responsibility f64: in-run {gap_h} m from hybrid, {gap_s} m "
          f"from host")
    c_n = len(d64.found)
    phase(14, f"(c) traffic light, behavior + responsibility 0.2, f64 on the card: "
              f"in-run FSM = hybrid = host sequential (steps {d64.steps}, statuses "
              f"{sorted(set(_dres_statuses(d64).values()))}), positions within "
              f"{max(gap_h, gap_s):.3e} m; in-run replayed "
              f"{1e3 * d64.wall_time / c_n:.3f} ms per cycle, hybrid "
              f"{1e3 * hyb.wall_time / c_n:.3f} ms per cycle [{smi}]")

    # (d) a responsibility fleet of three against the members' solo runs
    config = load_config()
    config.cost_weights["responsibility"] = 0.2
    sims = device_fleet(3, dev, "float32", config=config)
    check(all(s.resp_weight == 0.2 for s in sims), "fleet: no responsibility term")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fetches = host_count("device_sim.fetches")
    launches.start()
    t0 = time.perf_counter()
    results = device_sim.run_fleet(sims, sync_debug=True)
    wall = time.perf_counter() - t0
    launches.stop("responsibility fleet S=3", replayed=results[0].extras["k1_launches"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(host_count("device_sim.fetches") == fetches + 1,
          "a responsibility fleet run fetches once")
    gap = 0.0
    for i, (fleet_res, s) in enumerate(zip(results, sims)):
        solo = s.run()
        check(np.array_equal(fleet_res.status, solo.status) and fleet_res.steps == solo.steps,
              f"responsibility fleet member {i}: {fleet_res.status} steps "
              f"{fleet_res.steps} vs solo {solo.status} steps {solo.steps}")
        gap = max(gap, _dres_gap(fleet_res, solo))
    check(gap <= POS_TOL, f"responsibility fleet members {gap} m from their solo runs")
    c_max = max(s.n_cycles for s in sims)
    done = sum(int((r.status == 2).all()) for r in results)
    phase(14, f"(d) responsibility fleet S=3 (highway, overtake with 2 agents, curve), "
              f"replayed, 1 fetch: wall {wall:.3f} s with warm-up and capture "
              f"({results[0].extras['capture_s']:.3f} s), {3 / wall:.3f} scenarios/s, "
              f"{1e3 * wall / c_max:.3f} ms per cycle, peak memory {peak:.3f} GiB, "
              f"members at their goal {done}/3; every member equals its solo run, "
              f"positions within {gap:.3e} m, window slots kept "
              f"{len(device_sim._kept_slots(*(s.tensors for s in sims)))} [{smi}]")

    # (e) the window slots the run keeps, per family at its default size
    kept = {}
    for family, multi in (("highway", False), ("highway", True), ("overtake", True),
                          ("curve", False), ("convoy", True), ("traffic_light", False),
                          ("stop_sign", False), ("crosswalk", False)):
        config = load_config()
        config.simulation.start_multiagent = multi
        scenario = getattr(scenario_factory, f"make_{family}")()
        ds = device_sim.DeviceSimulation(Simulation(scenario, config, dev))
        kept[f"{family}{' A=' + str(len(ds.agents)) if multi else ''}"] = len(
            device_sim._kept_slots(ds.tensors))
    ds = device_sim.DeviceSimulation(_blind_spot_sim(dev, module_on=True))
    kept["blind spot A=2"] = len(device_sim._kept_slots(ds.tensors))
    phase(14, f"(e) window slots the run keeps of the nominal "
              f"{config.prediction.max_obstacles}: " + ", ".join(
                  f"{k} {v}" for k, v in kept.items()) + f" [{smi}]")


SIM_TABLES = ["batch_performance_measure", "global_performance_measure", "meta",
              "results", "scenario_evaluation"]


class _CliSpy:
    """What `run_scenario.main` did inside: the config and result of every
    `run_one`, the seconds of every `evaluate_simulation`, and the result of
    every device run and fleet.  Wraps the module attributes while active."""

    def __init__(self):
        self.runs, self.eval_s, self.device_runs = [], [], []

    @contextlib.contextmanager
    def active(self):
        real = (run_scenario.run_one, run_scenario.evaluate_simulation,
                device_sim.DeviceSimulation.run, device_sim.run_fleet)

        def run_one(target, config, *args, **kw):
            res = real[0](target, config, *args, **kw)
            self.runs.append((config, res))
            return res

        def evaluate(*args, **kw):
            t0 = time.perf_counter()
            out = real[1](*args, **kw)
            self.eval_s.append(time.perf_counter() - t0)
            return out

        def ds_run(ds, *args, **kw):
            dres = real[2](ds, *args, **kw)
            self.device_runs.append(([ds], [dres]))
            return dres

        def fleet(sims, *args, **kw):
            results = real[3](sims, *args, **kw)
            self.device_runs.append((list(sims), results))
            return results

        run_scenario.run_one, run_scenario.evaluate_simulation = run_one, evaluate
        device_sim.DeviceSimulation.run, device_sim.run_fleet = ds_run, fleet
        try:
            yield self
        finally:
            (run_scenario.run_one, run_scenario.evaluate_simulation,
             device_sim.DeviceSimulation.run, device_sim.run_fleet) = real


def _db(path):
    """{table: rows} of a SQLite file."""
    check(os.path.exists(path), f"{path} missing")
    con = sqlite3.connect(path)
    tables = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
    out = {t: con.execute(f"SELECT * FROM {t}").fetchall() for t in tables}
    out["_columns"] = {t: [c[1] for c in con.execute(f"PRAGMA table_info({t})")]
                       for t in tables}
    con.close()
    return out


def _cli(argv, what):
    rc = run_scenario.main(argv)
    check(rc == 0, f"{what}: run_scenario.main({argv}) exited {rc}")


def _cli_device_path(spy, what, launches, n_scenarios):
    """Checks of a device run or fleet driven through the CLI: one fetch,
    K1 launches = programs x cycles; returns the launches."""
    check(len(spy.device_runs) == 1, f"{what}: {len(spy.device_runs)} device runs")
    sims, results = spy.device_runs[0]
    check(len(results) == n_scenarios, f"{what}: {len(results)} results")
    k1 = results[0].extras["k1_launches"]
    programs = 2 * len(sims[0].levels)
    cycles = max(s.n_cycles for s in sims)
    check(k1 == programs * cycles,
          f"{what}: {k1} K1 launches, expected {programs} programs x {cycles} cycles")
    launches.stop(what, replayed=k1)
    return k1, programs, cycles


def phase_cli(dev, smi, launches):
    require_strict_tables()
    phase(15, f"SQLite {sqlite3.sqlite_version} (STRICT tables need 3.37)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        d = {k: os.path.join(root, k) for k in ("a", "a64", "b", "c", "d", "e", "f")}

        # (a) the highway with evaluation, on the card and in f64 on the CPU
        spy = _CliSpy()
        with spy.active():
            launches.start()
            _cli(["highway", "--evaluate", "--logs", d["a"], "--device", "cuda"], "(a)")
            n_a = launches.stop("cli highway --evaluate")
            _cli(["highway", "--evaluate", "--logs", d["a64"], "--device", "cpu",
                  "--set", "dtype=float64"], "(a) cpu f64")
        (cfg_a, res_a), (_, res_64) = spy.runs
        eval_a = spy.eval_s[0]
        check(res_a.success, f"(a): {res_a.agent_status}")
        hw = os.path.join(d["a"], "highway")
        for rel in ("60000/trajectories.db", "60000/logs.csv", "solution_60000.xml"):
            check(os.path.exists(os.path.join(hw, rel)), f"(a): {rel} missing")
        check(os.path.exists(os.path.join(d["a"], "score_overview.csv")),
              "(a): score_overview.csv missing")
        check(not os.path.exists(os.path.join(d["a"], "log_failures.csv")),
              "(a): log_failures.csv written")
        logger = logging.getLogger("frenetix_tpu_torch")
        (fh,) = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        fh.flush()
        with open(fh.baseFilename) as f:
            check("solution written" in f.read(), "(a): messages.log lacks the run")
        counts = {}
        for run, base in (("card", d["a"]), ("cpu", d["a64"])):
            sim_db = _db(os.path.join(base, "highway", "simulation.db"))
            traj_db = _db(os.path.join(base, "highway", "60000", "trajectories.db"))
            check(sorted(t for t in sim_db if t != "_columns") == SIM_TABLES,
                  f"(a) {run}: simulation.db tables {sorted(sim_db)}")
            counts[run] = ({t: len(r) for t, r in sim_db.items() if t != "_columns"},
                           {t: len(r) for t, r in traj_db.items() if t != "_columns"},
                           sim_db["_columns"]["scenario_evaluation"])
        check(counts["card"] == counts["cpu"],
              f"(a): row counts card {counts['card'][:2]} vs cpu f64 {counts['cpu'][:2]}")
        check(res_a.agent_status == res_64.agent_status and res_a.steps == res_64.steps,
              f"(a): card {res_a.agent_status} {res_a.steps} steps vs cpu f64 "
              f"{res_64.agent_status} {res_64.steps}")
        a = np.array([s.position for s in res_a.histories[60000]], np.float64)
        b = np.array([s.position for s in res_64.histories[60000]], np.float64)
        gap = float(np.abs(a - b).max())
        check(gap <= POS_TOL, f"(a): card positions {gap} m from cpu f64")
        n_cycles_a = len(res_a.planning_times)
        phase(15, f"(a) highway --evaluate on the card: success, {res_a.steps} steps, "
                  f"{n_cycles_a} cycles, K1 launches {n_a}, wall {res_a.wall_time:.3f} s "
                  f"= {1e3 * res_a.wall_time / n_cycles_a:.3f} ms per cycle with the logs, "
                  f"evaluation {eval_a:.3f} s; simulation.db rows {counts['card'][0]}, "
                  f"trajectories.db rows {counts['card'][1]}, "
                  f"{len(counts['card'][2]) - 4} metric columns: tables, row counts, "
                  f"statuses and steps equal the cpu f64 run, positions within "
                  f"{gap:.3e} m (limit {POS_TOL}) [{smi}]")

        # (b) the convoy, 8 agents, batched on the card
        spy = _CliSpy()
        with spy.active():
            launches.start()
            _cli(["convoy", "--multiagent", "--batched-agents", "--evaluate",
                  "--logs", d["b"]], "(b)")
            n_b = launches.stop("cli convoy --multiagent --batched-agents --evaluate")
        (_, res_b), = spy.runs
        conv = os.path.join(d["b"], "convoy")
        results_b = _db(os.path.join(conv, "simulation.db"))["results"]
        xmls = sorted(f for f in os.listdir(conv) if f.startswith("solution_"))
        ok_b = sum(s == 2 for s in (r[3] for r in results_b))
        check(len(results_b) == 8 and ok_b == 8 and len(xmls) == 8,
              f"(b): {len(results_b)} results rows, {ok_b} successes, {len(xmls)} XMLs")
        phase(15, f"(b) convoy --multiagent --batched-agents --evaluate on the card: "
                  f"results rows for 8 agents, 8 solution XMLs, {res_b.steps} steps, "
                  f"K1 launches {n_b}, wall {res_b.wall_time:.3f} s, evaluation "
                  f"{spy.eval_s[0]:.3f} s [{smi}]")

        # (c) the two-agent highway as one device run
        spy = _CliSpy()
        fetches = host_count("device_sim.fetches")
        with spy.active():
            launches.start()
            _cli(["highway", "--multiagent", "--device-sim", "--evaluate",
                  "--logs", d["c"]], "(c)")
        check(host_count("device_sim.fetches") == fetches + 1, "(c): a device run fetches once")
        k1_c, programs, cycles = _cli_device_path(
            spy, "cli highway --multiagent --device-sim --evaluate, replayed", launches, 1)
        (_, res_c), = spy.runs
        c_db = _db(os.path.join(d["c"], "highway", "simulation.db"))
        n_states = sum(len(h) for h in res_c.histories.values())
        check(len(c_db["meta"]) == 1 and len(c_db["scenario_evaluation"]) == n_states
              and not c_db["results"] and not c_db["global_performance_measure"]
              and not c_db["batch_performance_measure"],
              f"(c): simulation.db rows {({t: len(r) for t, r in c_db.items()})}")
        check(res_c.success and len([f for f in os.listdir(os.path.join(d["c"], "highway"))
                                     if f.startswith("solution_")]) == 2,
              f"(c): {res_c.agent_status}")
        phase(15, f"(c) highway --multiagent --device-sim --evaluate on the card: 2 "
                  f"agents at their goal, 1 fetch, K1 launches {k1_c} = {programs} x "
                  f"{cycles} cycles, replayed run {res_c.wall_time:.3f} s, evaluation "
                  f"{spy.eval_s[0]:.3f} s; simulation.db: meta 1, scenario_evaluation "
                  f"{n_states}, results / timing rows 0 (the device path's log set) "
                  f"[{smi}]")

        # (d) a fleet of two through the CLI
        spy = _CliSpy()
        fetches = host_count("device_sim.fetches")
        with spy.active():
            launches.start()
            _cli(["highway", "overtake", "--device-fleet", "--evaluate",
                  "--logs", d["d"]], "(d)")
        check(host_count("device_sim.fetches") == fetches + 1, "(d): a fleet run fetches once")
        k1_d, programs, cycles = _cli_device_path(
            spy, "cli highway overtake --device-fleet --evaluate, replayed", launches, 2)
        with open(os.path.join(d["d"], "score_overview.csv")) as f:
            n_rows = len(f.read().splitlines()) - 1
        check(n_rows == 2 and len(spy.eval_s) == 2
              and not os.path.exists(os.path.join(d["d"], "highway")),
              f"(d): {n_rows} score rows, {len(spy.eval_s)} evaluations")
        fleet_wall = spy.device_runs[0][1][0].wall_time
        phase(15, f"(d) highway overtake --device-fleet --evaluate on the card: 1 "
                  f"fetch, K1 launches {k1_d} = {programs} x {cycles} cycles, fleet "
                  f"wall {fleet_wall:.3f} s, evaluation "
                  f"{float(np.mean(spy.eval_s)):.3f} s per scenario; score rows 2, no "
                  f"per-scenario logs (as the JAX package's fleet) [{smi}]")

        # (e) --set: the vehicle database and the replanning frequency
        spy = _CliSpy()
        with spy.active():
            launches.start()
            _cli(["highway", "--logs", d["e"], "--set", "vehicle.cr_vehicle_id=2",
                  "--set", "planning.replanning_frequency=1"], "(e)")
            n_e = launches.stop("cli highway --set cr_vehicle_id=2, replanning 1")
        (cfg_e, res_e), = spy.runs
        check(tuple(cfg_e.vehicle) == tuple(resolve_vehicle(2))
              and cfg_e.vehicle.mass == 1093.295 and cfg_e.vehicle.delta_max == 1.066,
              f"(e): vehicle {cfg_e.vehicle}")
        with open(os.path.join(d["e"], "highway", "60000", "logs.csv")) as f:
            rows_e = len(f.read().splitlines()) - 1
        n_e_cycles = len(res_e.planning_times)
        executed = len(res_e.histories[60000]) - 1
        check(rows_e == n_e_cycles == executed
              and n_cycles_a == math.ceil((len(res_a.histories[60000]) - 1) / 3),
              f"(e): {rows_e} logged cycles, {n_e_cycles} planned, {executed} executed "
              f"steps; (a): {n_cycles_a} cycles")
        phase(15, f"(e) --set vehicle.cr_vehicle_id=2: mass {cfg_e.vehicle.mass} kg, "
                  f"delta_max {cfg_e.vehicle.delta_max} rad (BMW 320i); --set "
                  f"planning.replanning_frequency=1: {n_e_cycles} cycles for "
                  f"{executed} steps against {n_cycles_a} at 3; success "
                  f"{res_e.success}, K1 launches {n_e} [{smi}]")

        # (f) the cost of the logs: the highway with and without them
        spy = _CliSpy()
        with spy.active():
            launches.start()
            for i in range(2):
                _cli(["highway", "--logs", os.path.join(d["f"], f"on{i}")], "(f) logs")
                _cli(["highway", "--no-logging", "--logs", os.path.join(d["f"], f"off{i}")],
                     "(f) --no-logging")
            launches.stop("cli highway with and without the logs")
        per_cycle = [1e3 * r.wall_time / len(r.planning_times) for _, r in spy.runs]
        on, off = per_cycle[0::2], per_cycle[1::2]
        check(not os.path.exists(os.path.join(d["f"], "off0", "highway")),
              "(f): --no-logging wrote per-scenario logs")
        phase(15, f"(f) highway wall per cycle on the card: with the logs "
                  f"{on[0]:.3f} / {on[1]:.3f} ms, --no-logging {off[0]:.3f} / "
                  f"{off[1]:.3f} ms ({len(spy.runs[0][1].planning_times)} cycles each) "
                  f"[{smi}]")
    return {"no_logging_ms": off, "cpu64_steps": res_64.steps}


# ------------------------------------------------------------- phase 16: Wale-Net

WALENET_FILE = os.path.join("build", "walenet_synth.onnx")
WALENET_BATCHES = (1, 8, 16)
WALENET_OP_TOL = 1e-4          # per op and whole net: |card f32 - cpu f64| / max(1, max |cpu|)
# ops that only move or pick values: bitwise equal to the CPU float64 value
# rounded to float32 (rounding is monotonic, so a max pool commutes with it)
WALENET_EXACT_OPS = {"Shape", "Constant", "ConstantOfShape", "Gather", "Concat",
                     "Reshape", "Transpose", "Squeeze", "Unsqueeze", "Tile", "Expand",
                     "Slice", "MaxPool", "Identity"}


def _walenet_inputs(b, seed):
    """Histories (a random walk in metres), sparse neighbour rows and a
    0 / 127 / 255 raster: the preprocessing's value ranges."""
    rng = np.random.default_rng(seed)
    hist = np.cumsum(rng.normal(0.0, 1.0, (30, b, 2)), axis=0)
    nbrs = rng.normal(0.0, 8.0, (30, 39 * b, 2)) * (rng.uniform(size=(1, 39 * b, 1)) < 0.2)
    sc = rng.choice([0.0, 0.0, 0.0, 127.0, 255.0], size=(b, 1, 256, 256))
    return {"hist": hist, "nbrs": nbrs, "sc_img": sc}


def _walenet_op_errors(graph, dev, b):
    """Every node on the card in float32, fed the CPU float64 interpreter's
    own input values for it, against that node's CPU float64 output; then
    the whole net.  Returns (max op error, max net error, net output scale),
    errors relative to max(1, max |cpu|)."""
    cpu = torch.device("cpu")
    inputs = _walenet_inputs(b, seed=b)
    names = [o for n in graph.nodes for o in n.outputs if o]
    probe = OnnxGraph(nodes=graph.nodes, initializers=graph.initializers,
                      inputs=graph.inputs, outputs=names)
    in64 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inputs.items()}
    env = dict(zip(names, onnx_torch.build_torch_fn(probe, cpu, torch.float64)(**in64)))
    env.update(onnx_torch.graph_to_torch(graph, cpu, torch.float64))
    env.update(in64)
    card = onnx_torch.build_torch_fn(graph, dev, torch.float32)

    def to_card(x):
        if isinstance(x, np.ndarray):
            return x
        return x.to(dev, torch.float32 if x.is_floating_point() else x.dtype)

    op_err = 0.0
    for node in graph.nodes:
        outs = card.op(node.op_type, [to_card(env[n]) for n in node.inputs if n],
                       node.attrs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for name, got in zip(node.outputs, outs):
            if not name:
                continue
            want = env[name]
            if isinstance(want, np.ndarray):
                check(isinstance(got, np.ndarray) and np.array_equal(got, want),
                      f"walenet {node.name}: host value {got} vs {want}")
                continue
            got = got.cpu()
            if node.op_type in WALENET_EXACT_OPS:
                check(torch.equal(got, want.to(got.dtype)),
                      f"walenet {node.name} ({node.op_type}) B={b}: not bitwise the "
                      f"cpu float64 value in float32")
                continue
            err = float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))
            check(err <= WALENET_OP_TOL, f"walenet {node.name} ({node.op_type}) B={b}: "
                                         f"relative error {err} > {WALENET_OP_TOL}")
            op_err = max(op_err, err)
    got = card(**{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for k, v in inputs.items()})[0].cpu().double()
    want = env["predictions"]
    scale = max(1.0, float(want.abs().max()))
    net_err = float((got - want).abs().max()) / scale
    check(tuple(got.shape) == (40, b, 5) and bool(torch.isfinite(got).all()),
          f"walenet net B={b}: shape {tuple(got.shape)}")
    check(net_err <= WALENET_OP_TOL, f"walenet net B={b}: card f32 vs cpu f64 relative "
                                     f"error {net_err} > {WALENET_OP_TOL}")
    return op_err, net_err, scale


def _walenet_sim(family, dev, batched=False):
    config = load_config()
    config.dtype = "float32"
    config.prediction.mode = "walenet"
    config.simulation.start_multiagent = family == "convoy"
    config.simulation.batched_device_agents = batched
    return Simulation(getattr(scenario_factory, f"make_{family}")(), config, dev)


def _host_clock_ms(fn, n=5):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_walenet(dev, smi, launches):
    cpu = torch.device("cpu")
    os.makedirs(os.path.dirname(WALENET_FILE), exist_ok=True)
    # the writer's default widths are the recorded ones
    path = write_synthetic_walenet_onnx(WALENET_FILE, seed=0)
    walenet.WALENET_ONNX_PATH = path
    walenet._WALENET_CACHE.clear()
    walenet.WaleNet._net_cache.clear()
    graph = load_onnx(path)
    n_params = sum(int(v.size) for v in graph.initializers.values())
    phase(16, f"(a) synthetic Wale-Net export {path}: {os.path.getsize(path)} bytes, "
              f"{len(graph.nodes)} nodes, {n_params} weights, sc_conv1 "
              f"{graph.initializers['sc_conv1.weight'].shape}, ops "
              f"{sorted({n.op_type for n in graph.nodes})}")

    # (b) every op and the whole net on the card against the CPU float64
    for b in WALENET_BATCHES:
        op_err, net_err, scale = _walenet_op_errors(graph, dev, b)
        phase(16, f"(b) B={b}: {len(graph.nodes)} nodes on the card in float32 (TF32 "
                  f"off) against the cpu float64 interpreter: move/pick ops bitwise, "
                  f"the rest within {op_err:.3e} (limit {WALENET_OP_TOL}); the whole "
                  f"net within {net_err:.3e} relative of its scale {scale:.3f} [{smi}]")

    # (c) per call: the net (CUDA events), the preprocessing (host clock)
    scenario = scenario_factory.make_convoy(n_vehicles=max(WALENET_BATCHES))
    ids = [ob.obstacle_id for ob in scenario.dynamic_obstacles]
    net = walenet.WaleNet(scenario, device=dev)
    for b in WALENET_BATCHES:
        hist, nbrs, sc, _ = net._preprocess(ids[:b], 40)
        args = {k: torch.as_tensor(v, device=dev) for k, v in
                (("hist", hist), ("nbrs", nbrs), ("sc_img", sc))}
        net._net(**args)
        ms = cuda_ms(lambda: net._net(**args), 1, 5)
        wall = _host_clock_ms(lambda: net._net(**args))
        pre = _host_clock_ms(lambda: net._preprocess(ids[:b], 40))
        pred = _host_clock_ms(lambda: net.predict(ids[:b], 40))
        phase(16, f"(c) B={b}: net {ms:.3f} ms on the device (CUDA events), "
                  f"{wall:.3f} ms host clock per call; preprocessing (raster + "
                  f"neighbour grid) {pre:.3f} ms; predict (preprocess, one copy each "
                  f"way, net, postprocess) {pred:.3f} ms [{smi}]")

    # (d) the convoy A = 8 on the three paths
    runs = {}
    for path_name, batched in (("sequential", False), ("batched", True)):
        launches.start()
        res = _walenet_sim("convoy", dev, batched).run()
        launches.stop(f"walenet convoy host {path_name}")
        runs[path_name] = res
    sim = _walenet_sim("convoy", dev)
    ds = device_sim.DeviceSimulation(sim)
    fetches = host_count("device_sim.fetches")
    launches.start()
    dres = ds.run()
    programs = 2 * len(ds.levels)
    k1 = dres.extras["k1_launches"]
    launches.stop("walenet convoy device hybrid, replayed", replayed=k1)
    check(host_count("device_sim.fetches") - fetches == ds.n_cycles + 1,
          f"walenet device run: {host_count('device_sim.fetches') - fetches} fetches, "
          f"expected one per cycle + 1")
    check(k1 == programs * ds.n_cycles, f"walenet device run: {k1} K1 launches")
    seq, bat = runs["sequential"], runs["batched"]
    status = _dres_statuses(dres)
    for name, host in runs.items():
        check(status == _statuses(host) and dres.steps == host.steps,
              f"walenet convoy: device {status} {dres.steps} steps vs host {name} "
              f"{host.agent_status} {host.steps} steps")
    # the device run keeps the sequential loop's order; the batched step
    # retires a finished agent one step earlier, so it is held up to there
    gap_seq = _position_gap(dres, seq)
    retire = min(len(h) for r in (bat, seq) for h in r.histories.values())
    gap_bat = _history_gap(bat, seq, steps=retire)
    check(gap_seq <= POS_TOL, f"walenet convoy: device {gap_seq} m from the host "
                              f"sequential run (limit {POS_TOL})")
    check(gap_bat <= POS_TOL, f"walenet convoy: host batched {gap_bat} m from the "
                              f"sequential run up to step {retire - 1} (limit {POS_TOL})")
    c_n = ds.n_cycles
    phase(16, f"(d) walenet convoy A={len(ds.agents)}, {dres.steps} steps, statuses "
              f"{sorted(status.values())}: host sequential {seq.wall_time:.3f} s, host "
              f"batched {bat.wall_time:.3f} s, device hybrid replayed {dres.wall_time:.3f} "
              f"s = {1e3 * dres.wall_time / c_n:.3f} ms per cycle ({c_n} cycles, "
              f"{dres.extras['captures']} capture, {c_n + 1} fetches, K1 {k1} = "
              f"{programs} x {c_n}); equal statuses and steps; device positions within "
              f"{gap_seq:.3e} m of sequential, batched within {gap_bat:.3e} m of "
              f"sequential up to the first retirement (step {retire - 1}) (limit "
              f"{POS_TOL}) [{smi}]")

    # (e) a fleet of two, members one after another, each against its solo run
    families = ("highway", "overtake")
    sims = [device_sim.DeviceSimulation(_walenet_sim(f, dev)) for f in families]
    launches.start()
    t0 = time.perf_counter()
    results = device_sim.run_fleet(sims)
    fleet_wall = time.perf_counter() - t0
    launches.stop("walenet fleet S=2, replayed",
                  replayed=sum(r.extras["k1_launches"] for r in results))
    for family, res in zip(families, results):
        solo = device_sim.DeviceSimulation(_walenet_sim(family, dev)).run()
        check(res.extras["fleet_size"] == 2 and np.array_equal(res.status, solo.status)
              and res.steps == solo.steps
              and np.array_equal(res.trajectories, solo.trajectories),
              f"walenet fleet member {family}: {res.status} {res.steps} vs solo "
              f"{solo.status} {solo.steps}")
    phase(16, f"(e) walenet fleet S=2 (highway, overtake), members one after another: "
              f"wall {fleet_wall:.3f} s, statuses "
              f"{[r.status.tolist() for r in results]}, each equal to its solo run "
              f"[{smi}]")

    # (f) the command line
    with tempfile.TemporaryDirectory(prefix="chip_smoke_walenet_") as root:
        spy = _CliSpy()
        with spy.active():
            launches.start()
            _cli(["highway", "--prediction", "walenet", "--evaluate", "--logs", root,
                  "--device", "cuda"], "(f)")
            n_f = launches.stop("cli highway --prediction walenet --evaluate")
        (cfg_f, res_f), = spy.runs
        check(cfg_f.prediction.mode == "walenet" and os.path.exists(
            os.path.join(root, "highway", "solution_60000.xml")),
            f"(f): {cfg_f.prediction.mode}, {res_f.agent_status}")
        phase(16, f"(f) highway --prediction walenet --evaluate on the card: exit 0, "
                  f"{res_f.agent_status[60000].name}, {res_f.steps} steps, wall "
                  f"{res_f.wall_time:.3f} s = {1e3 * res_f.wall_time / len(res_f.planning_times):.3f} "
                  f"ms per cycle, evaluation {spy.eval_s[0]:.3f} s, K1 launches {n_f} "
                  f"[{smi}]")

    # (g) a missing export raises; nothing stands in
    walenet.WALENET_ONNX_PATH = os.path.join("build", "absent_walenet.onnx")
    walenet._WALENET_CACHE.clear()
    try:
        walenet.walenet_predictions(scenario, ids[:2], 40, 30, device=dev)
    except FileNotFoundError as e:
        phase(16, f"(g) missing export: FileNotFoundError ({e.strerror})")
    else:
        check(False, "walenet with a missing export did not raise")
    finally:
        walenet.WALENET_ONNX_PATH = path
        walenet._WALENET_CACHE.clear()


# ---------------------------------------------------------------- phase 17

MESH_STORE = os.path.join("build", "chip_smoke_mesh_store")


def _same_selection(a, b):
    """Two selection dicts of tensors bitwise equal, key by key."""
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _mesh_cycle(dev, smi, launches, mesh, batched_p50):
    """(b): the sharded cycle on phase 6's problem at W = 1."""
    from frenetix_tpu_torch.parallel.mesh import _poses_from, gather_rows, sharded_full_cycle

    matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
        A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
    batched = batched_full_cycle(dt=dt, n_steps=n_steps)
    sharded = sharded_full_cycle(mesh, dt=dt, n_steps=n_steps)
    ref = batched(matrices, masks, ctx)
    launches.start()
    out, poses = sharded(matrices, masks, ctx)
    check(launches.stop("sharded cycle W=1 (nccl)") == 1,
          "a sharded call launches K1 once on its rank")
    check(_same_selection(out, ref), "sharded cycle: the selection differs from the "
                                     "batched cycle's")
    check(torch.equal(poses, _poses_from(ref)), "sharded cycle: poses_all differ")
    check(bool(out["found"].all()), f"sharded cycle: found {out['found'].tolist()}")

    def run_batched():
        batched(matrices, masks, ctx)

    def run_sharded():
        sharded(matrices, masks, ctx)

    p50 = {}
    for name, fn in (("batched", run_batched), ("sharded", run_sharded),
                     ("sharded again", run_sharded), ("batched again", run_batched)):
        p50[name] = timed_calls(fn)[0]
    gather_p50 = timed_calls(lambda: gather_rows(mesh, ref))[0]
    phase(17, f"(b) sharded_full_cycle W=1 A={A_BATCH} M={M_BATCH} on the card: "
              f"selection and poses_all bitwise equal to batched_full_cycle, best "
              f"{out['best'].tolist()}, 1 K1 launch per call; p50 in turns: batched "
              f"{p50['batched']:.3f} / {p50['batched again']:.3f} ms, sharded "
              f"{p50['sharded']:.3f} / {p50['sharded again']:.3f} ms (phase 6 batched "
              f"{batched_p50:.3f} ms); the all-gather alone (gather_rows, one NCCL "
              f"call) p50 {gather_p50:.3f} ms [{smi}]")


def _mesh_device_run(dev, smi, launches, mesh, device_runs):
    """(c): the convoy's device run on the mesh, replayed with the NCCL
    all-gather inside the captured graph."""
    config = load_config()
    config.dtype = "float32"
    config.simulation.start_multiagent = True
    ds = device_sim.DeviceSimulation(
        Simulation(scenario_factory.make_convoy(), config, dev), mesh=mesh)
    programs = 2 * len(ds.levels)
    _run_once(ds, graph=False)
    eager, replayed, first = _replayed_and_eager(
        ds, "device-resident convoy, mesh W=1 (nccl)", launches, programs)
    base, base_ms, base_eager_ms = device_runs["convoy"]
    check(np.array_equal(replayed.status, base.status) and replayed.steps == base.steps,
          f"mesh convoy: status {replayed.status} steps {replayed.steps} vs phase 11 "
          f"{base.status} steps {base.steps}")
    n = replayed.steps
    gap = float(np.abs(replayed.trajectories[:n, :, :2].astype(np.float64)
                       - base.trajectories[:n, :, :2]).max())
    check(gap <= POS_TOL, f"mesh convoy {gap} m from phase 11's run (limit {POS_TOL})")
    bitwise = np.array_equal(replayed.trajectories, base.trajectories)
    c_n = ds.n_cycles
    phase(17, f"(c) convoy device-resident on the mesh W=1, 8 agents, {c_n} cycles of "
              f"{programs} programs each with its NCCL all-gather, 1 fetch per run, no "
              f"synchronisation in the loop: eager "
              f"{1e3 * eager.wall_time / c_n:.3f} ms per cycle, replayed with the "
              f"all-gather captured in the graph {1e3 * replayed.wall_time / c_n:.3f} ms "
              f"per cycle (capture {first.extras['capture_s']:.3f} s), replayed = eager "
              f"bitwise, K1 launches {first.extras['k1_launches']} = recorded x replays; "
              f"phase 11 unsharded: eager {base_eager_ms:.3f}, replayed {base_ms:.3f} ms "
              f"per cycle; statuses and steps ({n}) equal, positions within {gap:.3e} m "
              f"(bitwise {bitwise}) [{smi}]")


def _mesh_fleet(dev, smi, launches):
    """(d): a fleet of two split over the mesh against the unsharded fleet."""
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh

    fleet_mesh = make_agent_mesh(axis_name="scenarios")
    fetches = host_count("device_sim.fetches")
    launches.start()
    t0 = time.perf_counter()
    sharded = device_sim.run_fleet(device_fleet(2, dev, "float32"), mesh=fleet_mesh,
                                   sync_debug=True)
    wall = time.perf_counter() - t0
    n_k1 = launches.record("fleet S=2 over the mesh W=1, replayed",
                           sharded[0].extras["k1_launches"])
    check(host_count("device_sim.fetches") == fetches + 1, "a fleet on a mesh of one fetches once")
    plain = device_sim.run_fleet(device_fleet(2, dev, "float32"))
    for i, (a, b) in enumerate(zip(sharded, plain)):
        check(np.array_equal(a.status, b.status) and a.steps == b.steps
              and np.array_equal(a.trajectories, b.trajectories),
              f"mesh fleet member {i} differs from the unsharded fleet")
    phase(17, f"(d) run_fleet(device_fleet(2), mesh W=1) on the card: equal to the "
              f"unsharded fleet bitwise (statuses {[r.status.tolist() for r in sharded]}, "
              f"steps {[r.steps for r in sharded]}), 1 fetch, wall {wall:.3f} s with "
              f"warm-up and capture, K1 launches {n_k1} [{smi}]")


def _mesh_entry(dev, smi, launches):
    """(e): the entry twin on the card and the dry run in an NCCL rank."""
    from frenetix_tpu_torch.graft_entry import dryrun_multichip, entry

    fn64, args64 = entry(torch.device("cpu"), torch.float64)
    res64 = fn64(*args64)
    fn, args = entry(dev)
    launches.start()
    res = fn(*args)
    best = int(res.best_idx)
    launches.stop("graft_entry.entry() on the card")
    check(bool(res.found), "entry(): nothing found on the card")
    tie = _same_or_tie(best, int(res64.best_idx), res64.cost.numpy(), "entry()")
    t0 = time.perf_counter()
    ranks = dryrun_multichip(1, "cuda")
    wall = time.perf_counter() - t0
    n_k1 = launches.record("dryrun_multichip(1, cuda), its rank", ranks[0]["k1_launches"])
    phase(17, f"(e) entry() on the card: best_idx {best} (cpu f64 {int(res64.best_idx)}, "
              f"{tie} ties within {ULPS} float32 ulps); dryrun_multichip(1, 'cuda') in a "
              f"spawned NCCL rank: passed, K1 launches {n_k1}, wall {wall:.3f} s with the "
              f"process start [{smi}]")


def _mesh_workers(dev, smi, launches):
    """(f): --workers 2 through the CLI on the card against the sequential
    CLI run."""
    import csv

    seen = []
    real = run_scenario.run_pipeline

    def spy(*args, **kw):
        seen.extend(real(*args, **kw))
        return seen

    with tempfile.TemporaryDirectory(prefix="chip_smoke_workers_") as root:
        seq, par = os.path.join(root, "seq"), os.path.join(root, "par")
        launches.start()
        t0 = time.perf_counter()
        _cli(["highway", "overtake", "--logs", seq, "--device", "cuda", "--no-logging"],
             "(f) sequential")
        seq_s = time.perf_counter() - t0
        n_seq = launches.stop("cli highway overtake, sequential")
        run_scenario.run_pipeline = spy
        try:
            t0 = time.perf_counter()
            _cli(["highway", "overtake", "--logs", par, "--device", "cuda",
                  "--no-logging", "--workers", "2"], "(f) --workers 2")
            par_s = time.perf_counter() - t0
        finally:
            run_scenario.run_pipeline = real
        n_par = launches.record("cli highway overtake --workers 2 (workers' counts)",
                                sum(k for _, _, k in seen))
        rows = {}
        for name, d in (("seq", seq), ("par", par)):
            with open(os.path.join(d, "score_overview.csv"), newline="") as f:
                rows[name] = [r[:5] for r in csv.reader(f, delimiter=";")]
        check(rows["par"] == rows["seq"] and len(rows["seq"]) == 3,
              f"(f): --workers 2 rows {rows['par']} vs sequential {rows['seq']}")
        check(all(ok for _, ok, _ in seen) and all(k > 0 for _, _, k in seen),
              f"(f): workers {seen}")
    phase(17, f"(f) highway overtake --workers 2 on the card: score rows equal to the "
              f"sequential CLI run {[r[1:4] for r in rows['seq'][1:]]}; K1 launches "
              f"{n_par} in the workers ({[k for _, _, k in seen]}), {n_seq} sequential; "
              f"wall {par_s:.3f} s with 2 worker starts, sequential {seq_s:.3f} s [{smi}]")


def _rehearsal_rank(rank, world):
    """(g), one rank of the gloo world on the CPU."""
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh, sharded_full_cycle

    cpu = torch.device("cpu")
    matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
        A_BATCH, cpu, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
    mesh = make_agent_mesh()
    t0 = time.perf_counter()
    out, poses = sharded_full_cycle(mesh, dt=dt, n_steps=n_steps)(matrices, masks, ctx)
    cycle_s = time.perf_counter() - t0
    ref = batched_full_cycle(dt=dt, n_steps=n_steps)(matrices, masks, ctx)
    # the overtake at sampling level 1: a rehearsal of the split on the
    # host's CPU cores, not a measurement
    config = load_config()
    config.dtype = "float32"
    config.simulation.start_multiagent = True
    config.planning.sampling_min, config.planning.sampling_max = 1, 2
    t0 = time.perf_counter()
    sharded = device_sim.DeviceSimulation(
        Simulation(scenario_factory.make_overtake(), config, cpu), mesh=mesh).run()
    run_s = time.perf_counter() - t0
    solo = device_sim.DeviceSimulation(
        Simulation(scenario_factory.make_overtake(), config, cpu)).run()
    return dict(cycle_equal=_same_selection(out, ref), best=out["best"].tolist(),
                poses=poses.numpy(), cycle_s=cycle_s, run_s=run_s,
                status=(sharded.status.tolist(), solo.status.tolist()),
                steps=(sharded.steps, solo.steps),
                gap=float(np.abs(sharded.trajectories[:, :, :2]
                                 - solo.trajectories[:, :, :2]).max()))


def _mesh_rehearsal(smi):
    """(g): the split and the gather across two CPU processes."""
    from frenetix_tpu_torch.parallel.distributed import run_world

    t0 = time.perf_counter()
    ranks = run_world(_rehearsal_rank, 2, device="cpu", timeout=400)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        check(res["cycle_equal"], f"(g) rank {r}: the sharded cycle differs from the "
                                  f"batched cycle")
        check(res["status"][0] == res["status"][1] and res["steps"][0] == res["steps"][1]
              and res["gap"] <= POS_TOL, f"(g) rank {r}: sharded overtake {res}")
        check(np.array_equal(res["poses"], ranks[0]["poses"]), f"(g) rank {r}: poses")
    phase(17, f"(g) gloo rehearsal, 2 CPU ranks: sharded cycle A={A_BATCH} = batched on "
              f"every rank (best {ranks[0]['best']}), {ranks[0]['cycle_s']:.3f} s per call; "
              f"overtake DeviceSimulation(mesh=2 ranks) = solo (statuses "
              f"{ranks[0]['status'][0]}, steps {ranks[0]['steps'][0]}, positions within "
              f"{max(r['gap'] for r in ranks):.3e} m), {ranks[0]['run_s']:.3f} s per run; "
              f"world wall {wall:.3f} s with process starts (CPU, not the card) [{smi}]")


def phase_mesh(dev, smi, launches, batched_p50, device_runs):
    import frenetix_tpu_torch
    from frenetix_tpu_torch.parallel import distributed
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh

    os.makedirs(os.path.dirname(MESH_STORE), exist_ok=True)
    store = os.path.abspath(MESH_STORE)
    if os.path.exists(store):
        os.remove(store)
    check(distributed.initialize(init_method=f"file://{store}", num_processes=1,
                                 process_id=0, device="cuda"), "initialize() joined nothing")
    try:
        backend = torch.distributed.get_backend()
        check(backend == "nccl", f"backend {backend}")
        check(distributed.process_info() == (0, 1), f"{distributed.process_info()}")
        check(frenetix_tpu_torch.default_device() == dev, "default_device()")
        mesh = make_agent_mesh()
        phase(17, f"(a) initialize(): backend {backend}, process_info() (0, 1), "
                  f"default_device() {frenetix_tpu_torch.default_device()}, mesh "
                  f"{mesh.mesh.tolist()} of device type {mesh.device_type} [{smi}]")
        _mesh_cycle(dev, smi, launches, mesh, batched_p50)
        _mesh_device_run(dev, smi, launches, mesh, device_runs)
        _mesh_fleet(dev, smi, launches)
        _mesh_entry(dev, smi, launches)
    finally:
        torch.distributed.destroy_process_group()
    _mesh_workers(dev, smi, launches)
    _mesh_rehearsal(smi)


# ---------------------------------------------------------------- phase 18: plots


def _package_version(name):
    """The package's version, or None where it does not import."""
    try:
        module = importlib.import_module(name)
    except ImportError:
        return None
    return getattr(module, "__version__", "?")


def _plot_inputs(dev, dtype):
    """Phase 8's risk cycle on `dev`: (CycleResult, mask, TrajectoryRisks)."""
    matrix, mask, ctx, dt, n_steps = _risk_cycle_problem(dev, dtype)
    res = evaluate_cycle(matrix, mask, ctx, dt=dt, n_steps=n_steps, low_vel_mode=False)
    risks = trajectory_risks(res.rollout, ctx.preds, meta_from_footprint(
        ctx.preds.lengths, ctx.preds.widths), ctx.veh.mass)
    return res, mask, risks


def _picture_fetches(res, mask, risks):
    """Per picture, a call that fetches the arrays it draws as it fetches them
    (one `visualization.fetch` each): plot_scenario_at_timestep's candidate
    fan, risk_dashboard and plot_scenario_risk."""
    total = risks.ego_risk + risks.obst_risk
    ro = res.rollout
    return {
        "frame": lambda: visualization.fetch(ro.x, ro.y, res.cost, res.selectable,
                                             mask, res.best_idx),
        "risk_dashboard": lambda: visualization.fetch(res.cost, total, res.selectable,
                                                      res.best_idx),
        "scenario_risk": lambda: visualization.fetch(total, res.selectable, ro.x, ro.y,
                                                     res.best_idx),
    }


def _plot_inputs_on_card(dev, smi, launches):
    """(b): one cycle's plot inputs on the card, fetched in one copy per
    picture, against the CPU float64 cycle's."""
    launches.start()
    res, mask, risks = _plot_inputs(dev, torch.float32)
    launches.stop("plot inputs: risk cycle")
    want = {k: fn() for k, fn in _picture_fetches(
        *_plot_inputs(torch.device("cpu"), torch.float64)).items()}
    got, copies, ms = {}, {}, {}
    for name, fn in _picture_fetches(res, mask, risks).items():
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            before = visualization.FETCHES
            t0 = time.perf_counter()
            got[name] = fn()
            times.append(1e3 * (time.perf_counter() - t0))
            copies[name] = visualization.FETCHES - before
        ms[name] = float(np.median(times))
    check(all(n == 1 for n in copies.values()),
          f"(b): device-to-host copies per picture {copies}")
    x, y, cost, sel, m, best = got["frame"]
    x64, y64, cost64, sel64, m64, best64 = want["frame"]
    check(x.dtype == np.float32 and sel.dtype == bool and best.dtype == np.int32,
          f"(b): fetched dtypes {x.dtype}, {sel.dtype}, {best.dtype}")
    tie = _same_or_tie(int(best), int(best64), cost64, "(b) plot frame best_idx")
    check(np.array_equal(m, m64), "(b): the mask differs from the cpu f64 mask")
    n_sel_diff = int((sel != sel64).sum())
    check(n_sel_diff == 0 or tie, f"(b): selectable differs at {n_sel_diff} candidates")
    pos_gap = float(max(np.abs(x.astype(np.float64) - x64)[m].max(),
                        np.abs(y.astype(np.float64) - y64)[m].max()))
    check(pos_gap <= POS_TOL, f"(b): positions {pos_gap} m from cpu f64")
    risk_gap = float(np.abs(got["risk_dashboard"][1].astype(np.float64)
                            - want["risk_dashboard"][1]).max())
    check(risk_gap <= 1e-4, f"(b): total risk {risk_gap} from cpu f64 (limit 1e-4)")
    for name in ("risk_dashboard", "scenario_risk"):
        check([a.shape for a in got[name]] == [b.shape for b in want[name]],
              f"(b): {name}: shapes differ from the cpu f64 arrays")
    phase(18, f"(b) plot inputs of one risk cycle (M={M_BATCH}, 4 obstacles) on the "
              f"card f32 vs cpu f64: best_idx {int(best)} (cpu f64 {int(best64)}, "
              f"tie {bool(tie)}), selectable differs at {n_sel_diff} candidates, "
              f"positions within {pos_gap:.3e} m (limit {POS_TOL}), total risk within "
              f"{risk_gap:.3e} (limit 1e-4); device-to-host copies per picture "
              f"{copies}; ms per fetch "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{smi}]")


def _failures(logs):
    import csv

    path = os.path.join(logs, "log_failures.csv")
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=";"))


def _plots_fail_without(dev, smi, root):
    """(c): every plotting entry path fails with ImportError naming
    matplotlib before any K1 launch, and leaves its row in log_failures.csv."""
    package = "matplotlib"
    config = load_config()
    config.visualization.save_plots = True
    before = host_count("kernel.k1.launches")
    try:
        run_scenario.run_one("highway", config, log_dir=os.path.join(root, "one"),
                             device=dev)
    except ImportError as e:
        check(package in str(e), f"(c) run_one: {e!r} does not name {package}")
    else:
        check(False, f"(c): run_one drew without {package}")
    logs = os.path.join(root, "run_scenarios")
    run_scenarios(["highway"], config, dev, out=open(os.devnull, "w"), logs=logs)
    rows = {"run_one via run_scenarios": _failures(logs)}
    seen = []
    real = run_scenario.run_pipeline

    def spy(*args, **kw):
        seen.extend(real(*args, **kw))
        return seen

    run_scenario.run_pipeline = spy
    try:
        for i, flags in enumerate((["--device-sim", "--plot"], ["--plot", "--gif"],
                                   ["--workers", "2", "--plot"])):
            logs = os.path.join(root, f"cli{i}")
            rc = run_scenario.main(["highway", "overtake", "--device", dev.type,
                                    "--logs", logs, *flags])
            check(rc == 1, f"(c) {flags}: exit {rc}")
            rows[" ".join(flags)] = _failures(logs)
    finally:
        run_scenario.run_pipeline = real
    check(host_count("kernel.k1.launches") == before,
          f"(c): {host_count('kernel.k1.launches') - before} K1 launches without {package}")
    check(len(seen) == 2 and all(k == 0 and ok is None for _, ok, k in seen),
          f"(c): the workers report {seen}")
    for what, r in rows.items():
        n_expected = 1 if what.startswith("run_one") else 2
        check(len(r) == n_expected and all(
            row[1].startswith("ImportError") and package in row[1] for row in r),
              f"(c) {what}: log_failures.csv rows {[row[:2] for row in r]}")
    phase(18, f"(c) without {package}: run_one raised ImportError naming it; "
              f"run_scenarios and main with "
              + "; ".join(f"[{k}]" for k in rows if not k.startswith("run_one"))
              + f" exited 1 with {sum(len(r) for r in rows.values())} ImportError rows "
              f"in log_failures.csv; 0 K1 launches in this process, the workers "
              f"report {[k for _, _, k in seen]} [{smi}]")


def _plots_on_card(dev, smi, launches, root, cli):
    """(d): the highway with --plot --gif on the card writes the frame names
    of phase 15's cpu f64 run, final.png and run.gif, and launches K1 as its
    unplotted twin."""
    render_ms = []
    real = visualization.plot_scenario_at_timestep

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        render_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    spy = _CliSpy()
    plot_logs, twin_logs = os.path.join(root, "plot"), os.path.join(root, "twin")
    visualization.plot_scenario_at_timestep = timed
    try:
        with spy.active():
            launches.start()
            _cli(["highway", "--plot", "--gif", "--logs", plot_logs], "(d) --plot --gif")
            n_plot = launches.stop("cli highway --plot --gif")
            launches.start()
            _cli(["highway", "--logs", twin_logs], "(d) unplotted twin")
            n_twin = launches.stop("cli highway, the unplotted twin")
    finally:
        visualization.plot_scenario_at_timestep = real
    check(n_plot == n_twin, f"(d): K1 launches plotted {n_plot} vs unplotted {n_twin}")
    run = os.path.join(plot_logs, "highway")
    names = sorted(os.listdir(os.path.join(run, "frames")))
    steps64 = cli["cpu64_steps"]
    expected = [f"frame_{t:04d}.png" for t in range(5, steps64 + 1, 5)]
    check(names == expected, f"(d): frames {names[:3]}... vs the cpu f64 run's "
                             f"{expected[:3]}... ({steps64} steps)")
    for name in ("final.png", "run.gif"):
        check(os.path.getsize(os.path.join(run, name)) > 0, f"(d): {name} missing")
    check(not os.path.exists(os.path.join(plot_logs, "log_failures.csv")),
          "(d): log_failures.csv written")
    res = spy.runs[0][1]
    per_cycle = 1e3 * res.wall_time / len(res.planning_times)
    phase(18, f"(d) highway --plot --gif on the card: {len(names)} frames named as the "
              f"cpu f64 run's ({steps64} steps), final.png, run.gif; K1 launches "
              f"{n_plot} = the unplotted twin's; render {float(np.median(render_ms)):.1f} "
              f"ms per frame (median of {len(render_ms)}); plotted run "
              f"{per_cycle:.3f} ms per cycle beside phase 15's --no-logging "
              + " / ".join(f"{v:.3f}" for v in cli["no_logging_ms"]) + f" ms [{smi}]")


def phase_plots(dev, smi, launches, cli):
    versions = {name: _package_version(name) for name in ("matplotlib", "PIL")}
    phase(18, "(a) " + ", ".join(
        f"{k} {'imports, version ' + v if v else 'does not import'}"
        for k, v in versions.items()) + " on this machine")
    _plot_inputs_on_card(dev, smi, launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plots_") as root:
        if versions["matplotlib"] is None:
            _plots_fail_without(dev, smi, root)
        else:
            _plots_on_card(dev, smi, launches, root, cli)


# ---------------------------------------------------------------- phase 19

# the JAX package's subpackage re-exports, which the port offers under the
# same names
REEXPORTS = {
    "sim": ("Simulation", "SimulationResult"),
    "io": ("Scenario", "load_scenario"),
    "geometry": ("RefPathTable", "prepare_reference_path"),
    "planner": ("CycleContext", "CycleResult", "evaluate_cycle"),
    "risk": ("DEFAULT_HARM_COEFFS", "ObstacleMeta", "obstacle_mass",
             "obstacle_protection", "DEFAULT_RISK_MODES", "trajectory_risks"),
    "parallel": ("agent_pose_predictions", "batched_full_cycle", "concat_obstacles",
                 "make_agent_mesh", "sharded_full_cycle", "stack_cycle_contexts",
                 "distributed_initialize", "shard_scenarios", "DeviceSimResult",
                 "DeviceSimulation", "run_fleet"),
}
SURFACE_FAMILIES = (("s_curve", False), ("double_lane_change", True),
                    ("double_crossing", True))
INIT_AGENTS = 8
# the float32 initial state against the CPU float64 one, per output column
# relative to max(1, the column's largest |value|): float32 may project onto
# the other of two segments meeting at a vertex of the path (a few mm of s
# on the inside of a bend), which moves θ and so ḋ (2.1e-4 on the CPU)
INIT_F32_RTOL = 1e-3


def _family_sim(family, behavior):
    def make(device, dtype):
        config = load_config()
        config.dtype = dtype
        config.behavior.use_behavior_planner = behavior
        return Simulation(getattr(scenario_factory, f"make_{family}")(), config, device)
    return make


def _swaps(sim):
    """The steps at which the ego's behavior module rebuilt the reference
    path, filled while `sim` runs."""
    swaps = []
    agent = sim.agents[0]
    execute = agent.behavior.execute

    def recording(preds, state, t):
        out = execute(preds, state, t)
        if out.reference_path is not None:
            swaps.append(t)
        return out

    agent.behavior.execute = recording
    return swaps


def phase_surface(dev, smi, launches):
    from frenetix_tpu_torch.planner.initial_state import (
        compute_initial_state, compute_initial_state_np,
    )

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    # (a) the JAX package's names, re-exported by the port's subpackages
    for package, names in REEXPORTS.items():
        mod = importlib.import_module(f"frenetix_tpu_torch.{package}")
        missing = [n for n in names if not hasattr(mod, n)]
        check(not missing, f"frenetix_tpu_torch.{package} lacks {missing}")
    present = [m for m in ("jax", "yaml", "pandas", "matplotlib")
               if importlib.util.find_spec(m) is not None]
    check(not any(m in sys.modules for m in ("jax", "frenetix_tpu")),
          "jax or the JAX package was imported")
    phase(19, f"(a) {sum(map(len, REEXPORTS.values()))} re-exported names import from "
              f"frenetix_tpu_torch.{{{','.join(REEXPORTS)}}}; importable on this machine "
              f"of jax, yaml, pandas, matplotlib: {present or 'none'}")

    # (b) the tensor initial state of 8 agents: one K1 launch per call
    wheelbase = load_config().vehicle.wheelbase
    ref64, st64, refs, rows = initial_state_problem(INIT_AGENTS, cpu, torch.float64)
    want = [t.numpy() for t in compute_initial_state(ref64, st64, wheelbase, False)]
    want_np = [np.stack(c) for c in zip(*(compute_initial_state_np(r, s, wheelbase, False)
                                          for r, s in zip(refs, rows)))]
    for dtype in (torch.float32, torch.float64):
        ref, state, _, _ = initial_state_problem(INIT_AGENTS, dev, dtype)
        name = str(dtype).split(".")[-1]
        launches.start()
        got = compute_initial_state(ref, state, wheelbase, False)
        torch.cuda.synchronize()
        n = launches.stop(f"compute_initial_state A={INIT_AGENTS}, {name}")
        check(n == 1, f"compute_initial_state {name}: {n} K1 launches, not one")
        got = [t.double().cpu().numpy() for t in got]
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        err_np = max(float(np.abs(g - w).max()) for g, w in zip(got, want_np))
        rel = max(float((np.abs(g - w).max(0) / np.maximum(1.0, np.abs(w).max(0))).max())
                  for g, w in zip(got, want))
        bound = 1e-10 if dtype == torch.float64 else INIT_F32_RTOL
        check((err if dtype == torch.float64 else rel) <= bound,
              f"compute_initial_state {name}: {err} from cpu f64 (relative {rel})")
        p50 = timed_calls(lambda: compute_initial_state(ref, state, wheelbase, False))[0]
        phase(19, f"(b) compute_initial_state A={INIT_AGENTS} on the card in {name}: 1 K1 "
                  f"launch on the ({INIT_AGENTS}*{int(ref.s.shape[-1])}, 3) table, max |Δ| "
                  f"to cpu f64 {err:.3e} (per column relative to its scale {rel:.3e}, limit {bound}), to "
                  f"compute_initial_state_np {err_np:.3e}; p50 {p50:.3f} ms per call [{smi}]")

    # (c) the three families the JAX tests drive, float64 and float32
    for family, behavior in SURFACE_FAMILIES:
        make = _family_sim(family, behavior)

        def run64(device, counted):
            sim = make(device, "float64")
            swaps = _swaps(sim) if behavior else []
            if counted:
                launches.start()
            res = sim.run()
            if counted:
                launches.stop(f"{family}, float64")
            return res, swaps

        (r64, sw64), (ref, sw_ref) = run64(dev, True), run64(cpu, False)
        check(r64.success and _statuses(r64) == _statuses(ref) and r64.steps == ref.steps
              and sw64 == sw_ref,
              f"{family}: card f64 {r64.agent_status} steps {r64.steps} swaps {sw64} vs "
              f"cpu f64 {ref.agent_status} steps {ref.steps} swaps {sw_ref}")
        gap64 = _history_gap(r64, ref)
        check(gap64 <= BEH_POS_TOL, f"{family}: card f64 {gap64} m from cpu f64")
        r32, c32, parting, gap, flips = _f32_against_cpu(make, dev, f"{family}, float32",
                                                         launches)
        phase(19, f"(c) {family}{' with behavior' if behavior else ''}: card f64 = cpu "
                  f"f64 (steps {r64.steps}, success, reference path rebuilt at {sw64}, "
                  f"positions within {gap64:.3e} m), wall {r64.wall_time:.3f} s; "
                  f"{_parting_text(parting, gap, r32, c32, flips)}; card f32 gap to cpu f64 "
                  f"{_history_gap(r32, ref):.3e} m [{smi}]")

    # (d) the JAX CLI's --cpu in a process of its own: no card work at all
    code = ("import sys, torch\n"
            "from frenetix_tpu_torch import run_scenario\n"
            "from frenetix_tpu_torch.utils import tracing\n"
            "rc = run_scenario.main(['highway', '--cpu', '--logs', sys.argv[1]])\n"
            "print('K1', tracing.COUNTERS.get('kernel.k1.launches', 0), "
            "torch.cuda.is_initialized())\n"
            "sys.exit(rc)\n")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as logs:
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, logs], cwd=root, env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t1
    check(proc.returncode == 0, f"highway --cpu exited {proc.returncode}: {proc.stderr[-2000:]}")
    report = [line for line in proc.stdout.splitlines() if line.startswith("K1 ")]
    check(report == ["K1 0 False"], f"highway --cpu: {report} (want no K1 launch and no "
                                    f"CUDA context)")
    status = [line for line in proc.stdout.splitlines() if "status=" in line]
    phase(19, f"(d) run_scenario highway --cpu in a process of its own: exit 0, "
              f"{status[0].split(' message')[0] if status else ''}, 0 K1 launches, no CUDA "
              f"context; {wall:.1f} s")
    phase(19, f"phase 19 wall {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------- phase 20: compiled host paths

COMPILED_STEPS = 60        # steps of each simulation in phase 20
WALENET_NET_RTOL = 1e-6    # the net's predictions under capture, where not bitwise


def _capture_totals():
    """(graphs captured, capture seconds) over all compiled callables."""
    rows = compiled.stats().values()
    return sum(k for _, k, _ in rows), sum(s for _, _, s in rows)


def _run_states(sim, res):
    """Per agent the executed (x, y, θ, v, a) rows of a host run."""
    return {aid: np.array([[*st.position, st.orientation, st.velocity,
                            st.acceleration] for st in h])
            for aid, h in res.histories.items()}


def _compiled_against_eager(what, make_sim, launches, smi, rtol=None):
    """`make_sim()`'s run eager, compiled (capturing) and compiled again
    (replaying): equal statuses, steps and executed states (bitwise, or
    within `rtol` relative where given), equal K1 launches.  Returns
    (eager ms, replayed ms per cycle, captures, capture s)."""
    compiled.clear_all()      # the compiled run captures this path's programs
    runs = {}
    for how in ("eager", "compiled", "replayed"):
        guard = compiled.disable_compiled() if how == "eager" else contextlib.nullcontext()
        sim = make_sim()
        caps0, cap_s0 = _capture_totals()
        with guard:
            launches.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = launches.stop(f"20 {what}, {how}")
        caps, cap_s = _capture_totals()
        cycles = max(1, math.ceil(res.steps / sim.config.planning.replanning_frequency))
        runs[how] = dict(res=res, states=_run_states(sim, res), k1=n,
                         ms=1e3 * wall / cycles, captures=caps - caps0,
                         capture_s=cap_s - cap_s0)
    eager = runs["eager"]
    check(runs["eager"]["captures"] == 0, f"{what}: the eager twin captured a graph")
    check(runs["compiled"]["captures"] > 0, f"{what}: the compiled run captured nothing")
    check(runs["replayed"]["captures"] == 0, f"{what}: the second compiled run captured "
                                             f"{runs['replayed']['captures']} graphs")
    gap = 0.0
    for how in ("compiled", "replayed"):
        run = runs[how]
        check(run["res"].agent_status == eager["res"].agent_status
              and run["res"].steps == eager["res"].steps,
              f"{what} {how}: {run['res'].agent_status} in {run['res'].steps} steps vs "
              f"eager {eager['res'].agent_status} in {eager['res'].steps}")
        check(run["k1"] == eager["k1"], f"{what} {how}: K1 launches {run['k1']} vs "
                                        f"eager {eager['k1']}")
        for aid, rows in eager["states"].items():
            got = run["states"][aid]
            check(got.shape == rows.shape, f"{what} {how}: agent {aid} rows")
            if rtol is None:
                check(np.array_equal(got, rows), f"{what} {how}: agent {aid}'s states "
                                                 "differ from the eager twin's")
            else:
                gap = max(gap, float(np.abs(got - rows).max()))
    return runs, gap


def _phase20_sim(dev, family="highway", **setup):
    config = load_config()
    config.dtype = "float32"
    for key, value in setup.items():
        section, _, name = key.partition("__")
        if section == "cost_weights":
            config.cost_weights[name] = value
        elif section == "external_cost_weights":
            config.external_cost_weights[name] = value
        else:
            setattr(getattr(config, section), name, value)
    if family == "blind_spot":
        scenario = _blind_spot()
    elif family == "standing_lead":
        scenario = scenario_factory.make_highway(lead_v=0.0, lead_gap=14.0)
    else:
        scenario = getattr(scenario_factory, f"make_{family}")()
    sim = Simulation(scenario, config, dev)
    sim.max_steps = COMPILED_STEPS
    return sim


def _compiled_sharded(dev, smi, launches):
    """(h): the sharded cycle compiled against its eager twin at W = 1."""
    from frenetix_tpu_torch.parallel import distributed
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh, sharded_full_cycle

    os.makedirs(os.path.dirname(MESH_STORE), exist_ok=True)
    store = os.path.abspath(MESH_STORE + "_20")
    if os.path.exists(store):
        os.remove(store)
    check(distributed.initialize(init_method=f"file://{store}", num_processes=1,
                                 process_id=0, device="cuda"), "initialize() joined nothing")
    try:
        check(torch.distributed.get_backend() == "nccl", "phase 20 (h): not NCCL")
        mesh = make_agent_mesh()
        matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
            A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
        sharded = sharded_full_cycle(mesh, dt=dt, n_steps=n_steps)   # a new program
        with compiled.disable_compiled():
            launches.start()
            want, want_poses = sharded(matrices, masks, ctx)
            k1_eager = launches.stop("20 sharded cycle W=1, eager")
            eager_p50 = timed_calls(lambda: sharded(matrices, masks, ctx))[0]
        caps0, cap_s0 = _capture_totals()
        launches.start()
        got, poses = sharded(matrices, masks, ctx)
        k1 = launches.stop("20 sharded cycle W=1, compiled")
        caps, cap_s = _capture_totals()
        check(k1 == k1_eager, f"sharded: K1 {k1} vs eager {k1_eager}")
        check(_same_selection(got, want) and torch.equal(poses, want_poses),
              "sharded cycle: compiled differs from eager")
        p50 = timed_calls(lambda: sharded(matrices, masks, ctx))[0]
    finally:
        torch.distributed.destroy_process_group()
    phase(20, f"(h) sharded_full_cycle W=1 A={A_BATCH} under NCCL: compiled = eager "
              f"bitwise (selection, poses_all), K1 {k1} = {k1_eager}; {caps - caps0} "
              f"captures in {cap_s - cap_s0:.3f} s; p50 compiled {p50:.3f} ms vs eager "
              f"{eager_p50:.3f} ms per call [{smi}]")


def phase_compiled(dev, smi, launches):
    # (a) the dense cycle
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(dev, torch.float32)

    def dense():
        return evaluate_cycle(matrix, mask, ctx, dt=dt, n_steps=n_steps,
                              low_vel_mode=False, check_boundary=True)

    with compiled.disable_compiled():
        launches.start()
        want = dense()
        k1_eager = launches.stop("20 dense cycle, eager")
        eager_p50 = timed_calls(dense)[0]
    compiled.clear_all()
    caps0, cap_s0 = _capture_totals()
    launches.start()
    got = dense()
    k1 = launches.stop("20 dense cycle, compiled")
    caps, cap_s = _capture_totals()
    check(k1 == k1_eager, f"dense cycle: K1 {k1} vs eager {k1_eager}")
    for a, b in zip(_leaves(got), _leaves(want)):
        check(torch.equal(a, b), "dense cycle: compiled differs from eager")
    p50 = timed_calls(dense)[0]
    phase(20, f"(a) dense cycle M={matrix.shape[0]}: compiled = eager bitwise (every "
              f"CycleResult field), K1 {k1} = {k1_eager}; {caps - caps0} captures in "
              f"{cap_s - cap_s0:.3f} s; p50 compiled {p50:.3f} ms vs eager "
              f"{eager_p50:.3f} ms per call [{smi}]")

    # (b)-(f) host runs
    cases = (
        ("(b) highway", lambda: _phase20_sim(dev)),
        ("(c) batched convoy A=8", lambda: _phase20_sim(
            dev, "convoy", simulation__start_multiagent=True,
            simulation__batched_device_agents=True)),
        ("(d) min_risk, standing lead", lambda: _phase20_sim(
            dev, "standing_lead", planning__emergency_mode="min_risk",
            debug__log_risk=True)),
        ("(e) highway with responsibility 0.2", lambda: _phase20_sim(
            dev, simulation__start_multiagent=True, cost_weights__responsibility=0.2)),
        ("(f) gated blind spot", lambda: _phase20_sim(
            dev, "blind_spot", simulation__start_multiagent=True,
            occlusion__use_occlusion_module=True, occlusion__harm_threshold=0.02,
            external_cost_weights__occ_um=2.0, external_cost_weights__occ_ve=0.5,
            prediction__calc_occlusions=True)),
    )
    for what, make in cases:
        runs, _ = _compiled_against_eager(what, make, launches, smi)
        _print_compiled(what, runs, smi, "states bitwise equal")

    # (g) Wale-Net on the synthetic export at the recorded widths
    path = write_synthetic_walenet_onnx(WALENET_FILE, seed=0)
    walenet.WALENET_ONNX_PATH = path
    walenet._WALENET_CACHE.clear()
    walenet.WaleNet._net_cache.clear()
    scenario = scenario_factory.make_convoy(n_vehicles=8)
    net = walenet.WaleNet(scenario, device=dev)
    hist, nbrs, sc, _ = net._preprocess([ob.obstacle_id for ob in
                                         scenario.dynamic_obstacles], 40)
    inputs = [torch.as_tensor(a, device=dev) for a in (hist, nbrs, sc)]
    with compiled.disable_compiled():
        want = walenet._net_program(net._net, *inputs)
    got = walenet._net_program(net._net, *inputs)
    delta = float((got - want).abs().max())
    rel = delta / max(1.0, float(want.abs().max()))
    bitwise = torch.equal(got, want)
    check(bitwise or rel <= WALENET_NET_RTOL,
          f"walenet: the captured net differs by {rel:.3e} relative")
    runs, gap = _compiled_against_eager(
        "(g) walenet highway", lambda: _phase20_sim(dev, prediction__mode="walenet"),
        launches, smi, rtol=None if bitwise else WALENET_NET_RTOL)
    _print_compiled("(g) walenet highway", runs, smi,
                    f"net B={len(scenario.dynamic_obstacles)} bitwise={bitwise} (max "
                    f"|Δ| {delta:.3e}), states "
                    + ("bitwise equal" if bitwise else f"within {gap:.3e} m"))

    # (h) the sharded cycle under NCCL
    _compiled_sharded(dev, smi, launches)

    # (i) a host sync inside a compiled body fails its capture: no fallback
    @compiled.compiled
    def syncing(x):
        return x * float(x.sum().item())

    raised = None
    try:
        syncing(torch.ones(4, device=dev))
    except RuntimeError as e:
        # the capture's own error, and the one it chained
        raised = " <- ".join(str(x).splitlines()[0] for x in (e, e.__context__) if x)
    torch.cuda.synchronize()
    check(raised is not None, "a compiled body with .item() did not raise on the card")
    check(not syncing.entries, "a failed capture left an entry")
    phase(20, f"(i) a compiled body calling .item(): its capture raised "
              f"RuntimeError ({raised[:240]}), no entry, no eager fallback [{smi}]")


Q_SOURCE = "frenetix_tpu_torch/csrc/risk_quadrature.cu"
Q_ATOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# operations of one priced cell: per (rectangle, mean) pair and node 6 for
# the correlation terms and 12 per corner; per pair 12 for the standardised
# corners, 16 for the four Φ, 16 for the corner products and sums, 5 to
# combine and clamp
Q_OPS_PER_PRICED = 9 * (24 * (6 + 4 * 12) + 12 + 16 + 16 + 5) + 1
# per valid cell, the gate: three distances of 2 subtractions, 2 products,
# a sum, a root and a comparison
Q_OPS_PER_VALID = 3 * 7


class _QRollout(typing.NamedTuple):
    """The rollout fields the quadrature reads."""
    x: torch.Tensor
    y: torch.Tensor
    theta_gl: torch.Tensor


def _quadrature_problem(setting, dev, dtype, seed=0):
    """A rollout (A = 8, M = 1,024, N + 1 = 31) and 16 obstacle slots of
    predictions in the convoy cells' settings: "near" (per agent 1-2
    obstacles 7-18 m ahead and up to 3 m/s slower within 1 m of the lane,
    1-5 more at -25..-8 or 20-45 m), "open" (0-1 obstacle 25-50 m ahead and
    as fast or faster).  Candidates: end speeds around the agent's, lateral
    end offsets on [-3, 3] m, reached by a smooth ramp."""
    from frenetix_tpu_torch.ops.costs import PredictionTensors

    rng = np.random.default_rng(seed)
    a_n, m, n1, o = A_BATCH, M_BATCH, 31, O_SLOTS
    k = np.arange(n1) * 0.1
    v0 = rng.uniform(8.0, 14.0, (a_n, 1, 1))
    dv = rng.uniform(-4.0, 4.0, (a_n, m, 1))
    d_end = rng.uniform(-3.0, 3.0, (a_n, m, 1))
    ramp = np.clip(k / rng.uniform(1.1, 3.0, (a_n, m, 1)), 0.0, 1.0)
    ramp = ramp * ramp * (3.0 - 2.0 * ramp)
    x = rng.uniform(30.0, 60.0, (a_n, 1, 1)) + v0 * k + 0.5 * dv / 3.0 * k * k
    y = rng.uniform(-1.0, 1.0, (a_n, 1, 1)) + d_end * ramp
    theta = np.arctan2(np.gradient(y, axis=-1), np.gradient(x, axis=-1))
    means = np.zeros((a_n, o, n1, 2))
    valid = np.zeros((a_n, o, n1), bool)
    for a in range(a_n):
        if setting == "near":
            groups = [(rng.integers(1, 3), [(7.0, 18.0)], 1.0, (-3.0, 0.0)),
                      (rng.integers(1, 6), [(-25.0, -8.0), (20.0, 45.0)], 4.0, (-3.0, 3.0))]
        else:
            groups = [(rng.integers(0, 2), [(25.0, 50.0)], 1.0, (0.0, 3.0))]
        slot = 0
        for count, spans, lateral, speed in groups:
            for _ in range(count):
                lo, hi = spans[rng.integers(len(spans))]
                s0 = x[a, 0, 0] + rng.uniform(lo, hi)
                v = v0[a, 0, 0] + rng.uniform(*speed)
                means[a, slot, :, 0] = s0 + v * k
                means[a, slot, :, 1] = rng.uniform(-lateral, lateral)
                valid[a, slot] = True
                slot += 1
    covs = np.broadcast_to(0.5 * np.eye(2), (a_n, o, n1, 2, 2)).copy()

    def t(arr, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dt, device=dev)

    ro = _QRollout(x=t(x), y=t(y),
                    theta_gl=t(theta))
    preds = PredictionTensors(
        means=t(means), inv_covs=t(covs * 4.0), covs=t(covs),
        orientations=t(np.zeros((a_n, o, n1))), velocities=t(np.ones((a_n, o, n1))),
        lengths=t(np.full((a_n, o), 4.5)), widths=t(np.full((a_n, o), 1.8)),
        valid=t(valid, torch.bool))
    return ro, preds


def _quadrature_cells(ro, preds, t):
    """(valid cells, priced cells): cells on a valid slot, and of those the
    cells inside the 5 m gate, by the twin's formula."""
    ego = torch.stack([ro.x[..., 1:t + 1], ro.y[..., 1:t + 1]], dim=-1)
    yaw = preds.orientations[..., 1:t + 1]
    half = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1) * (
        preds.lengths[..., None, None] / 2.0)
    centre = preds.means[..., :t, :]
    dists = [torch.sqrt(torch.sum((p.unsqueeze(-4) - ego.unsqueeze(-3)) ** 2, dim=-1))
             for p in (centre, centre + half, centre - half)]
    valid = preds.valid[..., None, :, :t].expand(dists[0].shape)
    return valid, valid & (torch.amin(torch.stack(dists), dim=0) <= 5.0)


def q_bound_ms(shape, itemsize, n_valid, n_priced, floor_ms):
    """The least time the card could take for one Q call on (B, M, O, t):
    the larger of its bytes (the three rectangle centres and the three
    means, sx, sy, ρ and the slot mask read once, the result written once)
    at 3.35 TB/s, the gate's and the priced cells' operations at 67 TFLOP/s,
    and the launch floor.  Returns (ms, what bounds it, bytes, operations)."""
    b, m, o, t = shape
    n_bytes = (3 * b * m * t * 2 + 3 * b * o * t * 2 + 3 * b * o * t + b * m * o * t) \
        * itemsize + b * o * t
    n_ops = Q_OPS_PER_VALID * n_valid + Q_OPS_PER_PRICED * n_priced
    by = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": n_ops / F32_FLOPS * 1e3,
          "launch floor": floor_ms}
    what = max(by, key=by.get)
    return by[what], what, n_bytes, n_ops


def phase_quadrature(dev, smi, floor_ms):
    from frenetix_tpu_torch.ops.kinematics import VehicleParams
    from frenetix_tpu_torch.risk import probability

    veh = VehicleParams()
    results = {}
    for setting in ("near", "open"):
        for dtype in (torch.float32, torch.float64):
            ro, preds = _quadrature_problem(setting, dev, dtype)
            got, t = probability.collision_probability_fast(ro, preds, veh)
            want, _ = probability.collision_probability_fast(ro, preds, veh, plain=True)
            torch.cuda.synchronize()
            valid, priced = _quadrature_cells(ro, preds, t)
            n_priced, n_valid = int(priced.sum()), int(valid.sum())
            dead = ~priced
            check(bool((got[dead] == 0).all()) and not bool(torch.signbit(got[dead]).any()),
                  f"Q {setting} {dtype}: a cell it does not price is not +0.0")
            check(bool((want[dead] == 0).all()), f"twin {setting}: non-zero beyond the gate")
            diff = (got - want)[priced].abs()
            err = float(diff.max()) if n_priced else 0.0
            check(err <= Q_ATOL[dtype], f"Q {setting} {dtype}: max |Δ| {err} > "
                                        f"{Q_ATOL[dtype]}")
            n_bitwise = int((diff == 0).sum()) if n_priced else 0
            inputs = probability._kernel_inputs(ro, preds, veh, t)
            ms = cuda_ms(lambda: probability._quadrature(*inputs, veh), 20, 5)
            call_ms = cuda_ms(
                lambda: probability.collision_probability_fast(ro, preds, veh), 20, 5)
            plain_ms = cuda_ms(lambda: probability.collision_probability_fast(
                ro, preds, veh, plain=True), 2, 3)
            bound, by, n_bytes, n_ops = q_bound_ms(tuple(got.shape), got.element_size(),
                                                   n_valid, n_priced, floor_ms)
            name = str(dtype).split(".")[-1]
            results[(setting, dtype)] = dict(
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bytes=n_bytes,
                ops=n_ops, max_abs_err=err, priced_share=100.0 * n_priced / got.numel(),
                priced=n_priced, bitwise_priced=n_bitwise)
            phase(21, f"Q {setting} {name} {tuple(got.shape)}: priced {n_priced} of "
                      f"{got.numel()} cells ({100.0 * n_priced / got.numel():.3f} %), "
                      f"{n_valid} on valid slots; +0.0 on every other; max |Δ| vs the "
                      f"plain twin {err:.3e} ({n_bitwise} of {n_priced} priced bitwise); "
                      f"kernel {ms:.4f} ms (the call with its preparation {call_ms:.4f} "
                      f"ms), plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
                      f"by {by} ({n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} G operations) "
                      f"= {bound / ms:.3f} of the kernel's time [{smi}]")

    # the batched convoy path: one Q launch per call, compiled and replaying
    matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
        A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True,
        o_slots=O_SLOTS)
    grid, _, _ = stacked_post_pass_extras(ctx)
    fn = batched_full_cycle(dt=dt, n_steps=n_steps, resp_weight=0.2)
    fn.clear()
    before = host_count("kernel.q.launches")
    calls = 5
    for _ in range(calls):
        fn(matrices, masks, ctx, grid)
    torch.cuda.synchronize()
    n_launches = host_count("kernel.q.launches") - before
    check(n_launches == calls, f"batched convoy path: {n_launches} Q launches in "
                               f"{calls} calls")
    p50, lo, hi = timed_calls(lambda: fn(matrices, masks, ctx, grid))
    phase(21, f"batched cycle with responsibility A={A_BATCH} M={M_BATCH} O={O_SLOTS}: "
              f"{n_launches} Q launches in {calls} calls (captures {fn.captures}); p50 "
              f"{p50:.3f} ms over 20 calls (min {lo:.3f}, max {hi:.3f}) [{smi}]")
    return results, n_launches


K2_SOURCE = "frenetix_tpu_torch/csrc/rollout.cu"
# the Rollout's (..., M, N+1) fields besides K1's extra columns
ROLLOUT_FIELDS = 14


def k2_bytes(n_rows, n1, n_extra, itemsize):
    """(floor, design) bytes of one rollout of `n_rows` candidates: the floor
    reads the (M, 13) matrix once and writes the fourteen (M, N+1) fields,
    the 12 coefficients, traj_len, the 11 slots, feasible and valid once;
    the design adds the matrix's second read (K2b), K1's rows and factors
    (written by K2a, read by K1), K1's (5 + K) columns (written) and K1's
    five columns that K2b reads back; the (A·R, C) table is left out (a
    few hundred KB, in L2)."""
    p = n_rows * n1
    per_row = 12 * itemsize + 4 + 11 + 2
    floor = n_rows * 13 * itemsize + ROLLOUT_FIELDS * p * itemsize + n_rows * per_row
    design = (floor + n_rows * 13 * itemsize + 2 * p * (4 + itemsize)
              + (5 + n_extra) * p * itemsize + 5 * p * itemsize)
    return floor, design


@contextlib.contextmanager
def _plain_spy():
    """Yields a one-element list that counts the calls of the plain twins
    `ops.kinematics.rollout_candidates_plain` and
    `planner.core.cycle_stages_plain` given CUDA tensors while the block
    runs (the main paths must make none)."""
    from frenetix_tpu_torch.ops import kinematics
    from frenetix_tpu_torch.planner import core

    cuda_calls = [0]
    originals = (kinematics.rollout_candidates_plain, core.cycle_stages_plain)

    def spying(original):
        def spy(first, *args, **kw):
            tensor = first if isinstance(first, torch.Tensor) else first.x
            cuda_calls[0] += tensor.device.type == "cuda"
            return original(first, *args, **kw)
        return spy

    kinematics.rollout_candidates_plain = spying(originals[0])
    core.cycle_stages_plain = spying(originals[1])
    try:
        yield cuda_calls
    finally:
        kinematics.rollout_candidates_plain, core.cycle_stages_plain = originals


@contextlib.contextmanager
def _rollout_twin_in_programs():
    """The programs' rollout as the plain twin (the parent's), to count and
    time them as they were: `planner.core`'s name is rebound, compiled
    entries are dropped on the way in and out."""
    from frenetix_tpu_torch.ops import kinematics
    from frenetix_tpu_torch.planner import core

    compiled.clear_all()
    core.rollout_candidates = kinematics.rollout_candidates_plain
    try:
        yield
    finally:
        core.rollout_candidates = kinematics.rollout_candidates
        compiled.clear_all()


def _kernels_per_call(fn, calls, units=1):
    """(kernels, device busy ms) per unit of `calls` calls of `fn` under
    `torch.profiler`, after 3 warm-up calls; one call does `units` units."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    n = calls * units
    return len(events) / n, sum(ev.device_time for ev in events) / 1e3 / n


class _Recorded(Exception):
    """Ends an eager run once the rollouts wanted are recorded."""


def _recorded_calls(ds, n, name="rollout_candidates"):
    """The arguments of the first `n` calls of `planner.core`'s `name` in an
    eager run of `ds` (the run is abandoned after them)."""
    from frenetix_tpu_torch.planner import core

    calls, original = [], getattr(core, name)

    def recording(*args, **kw):
        calls.append((args, kw))
        if len(calls) == n:
            raise _Recorded
        return original(*args, **kw)

    setattr(core, name, recording)
    try:
        ds.run(graph=False)
    except _Recorded:
        pass
    finally:
        setattr(core, name, original)
    return calls


def _k2_paths(dev, smi, spy):
    """(c): K2's launches on every main path against its rollouts, and K1's."""
    counts = {}

    def counted(path, fn, rollouts, facts=None):
        """Run `fn`; its K2 launches (a replayed run's own figures, read by
        `facts` from what `fn` returned) must equal `rollouts`, and K3's
        K2's."""
        names = ("k1", "k2", "k3")
        before = [host_count(f"kernel.{k}.launches") for k in names]
        out = fn()
        torch.cuda.synchronize()
        n1, n2, n3 = (host_count(f"kernel.{k}.launches") - b for k, b in zip(names, before))
        if facts is not None:
            n1, n2, n3 = (facts(out)[f"{k}_launches"] for k in names)
        want = rollouts(out) if callable(rollouts) else rollouts
        check(n2 == want and n2 > 0,
              f"{path}: {n2} K2 launches for {want} rollouts (K1 {n1})")
        check(n3 == n2, f"{path}: {n3} K3 launches for {n2} K2 launch pairs")
        counts[path] = dict(k2=n2, k1=n1, k3=n3, rollouts=want)
        return out

    # the dense cycle, compiled: its replays
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(dev, torch.float32)
    compiled.clear_all()
    evaluate_cycle(matrix, mask, ctx, dt=dt, n_steps=n_steps, low_vel_mode=False)
    counted("dense cycle, 5 replays", lambda: [evaluate_cycle(
        matrix, mask, ctx, dt=dt, n_steps=n_steps, low_vel_mode=False)
        for _ in range(5)], 5)
    # the JAX entry's twin (graft_entry.entry), compiled: its replays
    from frenetix_tpu_torch.graft_entry import entry

    entry_fn, entry_args = entry(dev)
    entry_fn(*entry_args)
    counted("graft_entry.entry(), 2 replays",
            lambda: [entry_fn(*entry_args) for _ in range(2)], 2)
    # the host planner (planner/reactive.py): one rollout per evaluate_cycle
    calls = [0]
    original = reactive.evaluate_cycle

    def counting(*args, **kw):
        calls[0] += 1
        return original(*args, **kw)

    reactive.evaluate_cycle = counting
    try:
        sim = _phase20_sim(dev)
        sim.max_steps = 30
        counted("host planner, highway 30 steps", sim.run, lambda out: calls[0])
    finally:
        reactive.evaluate_cycle = original
    # the batched cycle (mesh.batched_full_cycle), compiled, and its eager body
    matrices, masks, ctx_b, _, dt, n_steps = stacked_cycle_problem(
        A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
    fn = batched_full_cycle(dt=dt, n_steps=n_steps)
    fn(matrices, masks, ctx_b)
    counted("batched cycle, 5 replays", lambda: [fn(matrices, masks, ctx_b)
                                                 for _ in range(5)], 5)
    with compiled.disable_compiled():
        counted("batched cycle, eager", lambda: fn(matrices, masks, ctx_b), 1)
    # the sharded cycle at W = 1 under NCCL
    from frenetix_tpu_torch.parallel import distributed
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh, sharded_full_cycle

    os.makedirs(os.path.dirname(MESH_STORE), exist_ok=True)
    store = os.path.abspath(MESH_STORE + "_22")
    if os.path.exists(store):
        os.remove(store)
    check(distributed.initialize(init_method=f"file://{store}", num_processes=1,
                                 process_id=0, device="cuda"), "initialize() joined nothing")
    try:
        sharded = sharded_full_cycle(make_agent_mesh(), dt=dt, n_steps=n_steps)
        sharded(matrices, masks, ctx_b)
        counted("sharded cycle W=1, 3 replays", lambda: [sharded(matrices, masks, ctx_b)
                                                         for _ in range(3)], 3)
    finally:
        torch.distributed.destroy_process_group()
    # the device run, the in-run FSM and a fleet: rollouts = K1's programs
    ds = _device_sim("convoy", dev)
    for graph in (False, True):
        counted(f"device run convoy, {'replayed' if graph else 'eager'}",
                lambda graph=graph: ds.run(graph=graph), 2 * ds.n_cycles,
                facts=lambda res: res.extras)
    fsm = device_sim.DeviceSimulation(_behavior_sim("traffic_light", dev, "float32"))
    # (K1 runs only inside the rollouts of a device run: its count is theirs)
    counted("device run with the in-run FSM, replayed", lambda: fsm.run(graph=True),
            lambda res: res.extras["k1_launches"], facts=lambda res: res.extras)
    counted("fleet of 2 (highway, overtake), replayed",
            lambda: device_sim.run_fleet(device_fleet(2, dev)),
            lambda res: res[0].extras["k1_launches"], facts=lambda res: res[0].extras)
    check(spy[0] == 0, f"{spy[0]} CUDA calls reached the plain twins")
    for path, c in counts.items():
        phase(22, f"(c) {path}: K2 {c['k2']} launch pairs = {c['rollouts']} rollouts; "
                  f"K1 {c['k1']}; K3 {c['k3']} [{smi}]")
    return counts


def phase_rollout(dev, smi, floor_ms):
    """Phase 22, kernel K2: (a) bitwise against the plain twin and (b) times
    at the dense, batched and device-run shapes, (c) launches on every main
    path, (d) kernels per replay of the programs with the twin and with K2."""
    from frenetix_tpu_torch.ops import kinematics

    shapes = {}
    for dtype in (torch.float32, torch.float64):
        matrix, _, ctx, dt, n_steps, _ = dense_cycle_problem(dev, dtype)
        matrices, _, ctx_b, _, _, _ = stacked_cycle_problem(
            A_BATCH, dev, dtype, m_bucket=M_BATCH, spread=12.0, ragged=True, o_slots=O_SLOTS)
        for what, m, c in (("dense", matrix, ctx), ("batched", matrices, ctx_b)):
            shapes[(what, dtype)] = ((m, c.ref, c.veh), dict(
                dt=dt, n_steps=n_steps, low_vel_mode=False, x0_orientation=c.x0_orientation,
                extra_ref_tables=c.corridor, table_window=768))
    ds = _device_sim("convoy", dev)
    for (args, kw), mode in zip(_recorded_calls(ds, 2), ("", " low_vel")):
        shapes[(f"device run{mode}", torch.float32)] = (args, kw)
    results = {}
    for (what, dtype), (call_args, call_kw) in shapes.items():
        matrix = call_args[0]
        before = host_count("kernel.k2.launches")
        got = kinematics.rollout_candidates(*call_args, **call_kw)
        check(host_count("kernel.k2.launches") == before + 1, f"K2 {what}: not one launch pair")
        want = kinematics.rollout_candidates_plain(*call_args, **call_kw)
        torch.cuda.synchronize()
        for name in kinematics.Rollout._fields:
            g, w = getattr(got, name), getattr(want, name)
            if name == "extras":
                g, w = torch.stack(g), torch.stack(w)
            if g.dtype.is_floating_point:
                ints = torch.int32 if g.dtype == torch.float32 else torch.int64
                g, w = g.contiguous().view(ints), w.contiguous().view(ints)
            check(torch.equal(g, w), f"K2 {what} {dtype}: {name} differs from the twin")
        n_rows = matrix.numel() // 13
        n1 = call_kw["n_steps"] + 1
        ms = cuda_ms(lambda: kinematics.rollout_candidates(*call_args, **call_kw), 20, 5)
        plain_ms = cuda_ms(
            lambda: kinematics.rollout_candidates_plain(*call_args, **call_kw), 3, 5)
        n_extra = 0 if got.extras is None else len(got.extras)
        floor, design = k2_bytes(n_rows, n1, n_extra, matrix.element_size())
        bound = max(floor / HBM_BYTES_PER_S * 1e3, 3 * floor_ms)
        name = str(dtype).split(".")[-1]
        results[(what, dtype)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, floor_bytes=floor,
            design_bytes=design, rows=n_rows, n1=n1,
            infeasible_share=float(got.inf_slots[..., 0].float().mean()))
        phase(22, f"(a, b) K2 {what} {name} rows={n_rows} N+1={n1}: bitwise equal to the "
                  f"plain twin in all {len(kinematics.Rollout._fields)} fields; K2a + K1 + "
                  f"K2b {ms:.4f} ms, plain twin {plain_ms:.4f} ms ({plain_ms / ms:.1f}x); "
                  f"bound max(floor {floor / 1e6:.2f} MB at 3.35 TB/s, 3 launch floors) "
                  f"{bound:.4f} ms = {bound / ms:.3f} of K2's time; the design moves "
                  f"{design / 1e6:.2f} MB ({design / floor:.2f}x the floor) [{smi}]")

    # K2's three kernels apart, at the dense shape (device time per call)
    from torch.profiler import ProfilerActivity, profile

    dense_args, dense_kw = shapes[("dense", torch.float32)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kinematics.rollout_candidates(*dense_args, **dense_kw)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + ev.device_time / 1e3 / 10
    for kernel, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        phase(22, f"(b) dense float32, profiled: {ms:.4f} ms per call in {kernel[:80]} "
                  f"[{smi}]")

    with _plain_spy() as spy:
        counts = _k2_paths(dev, smi, spy)

    # (d) kernels per replay, with the plain twin (the parent's program) and K2
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(dev, torch.float32)
    matrices, masks, ctx_b, _, _, _ = stacked_cycle_problem(
        A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
    programs = {}
    for label, ctxm in (("twin", _rollout_twin_in_programs), ("K2", contextlib.nullcontext)):
        with ctxm():
            compiled.clear_all()
            dense = _kernels_per_call(lambda: evaluate_cycle(
                matrix, mask, ctx, dt=dt, n_steps=n_steps, low_vel_mode=False), 10)
            fn = batched_full_cycle(dt=dt, n_steps=n_steps)
            fn.clear()
            batched = _kernels_per_call(lambda: fn(matrices, masks, ctx_b), 10)
            run = _device_sim("convoy", dev)
            cycles = run.n_cycles
            device_run = _kernels_per_call(lambda: run.run(graph=True), 1, units=cycles)
            programs[label] = dict(dense=dense, batched=batched, device_run=device_run)
    for what in ("dense", "batched", "device_run"):
        (n0, b0), (n1_, b1) = programs["twin"][what], programs["K2"][what]
        phase(22, f"(d) {what} program replayed, per {'cycle' if what == 'device_run' else 'call'}"
                  f": {n0:.0f} -> {n1_:.0f} kernels, device busy {b0:.3f} -> {b1:.3f} ms "
                  f"(profiled; twin -> K2) [{smi}]")
    return results, counts, programs


K3_SOURCE = "frenetix_tpu_torch/csrc/cycle.cu"


def k3_bytes(n_rows, n1, itemsize, n_agents=1, n_slots=0, horizon=0, n_obstacles=0,
             n_segments=0, boundary=True):
    """The floor of K3's bytes: per row the Rollout's x, y, theta_gl,
    theta_cl, v, a, d (and the two corridor columns) read once, the six
    coefficients of the jerk integrals, feasible, valid and the mask; the
    13 terms, the total, the harm, the step and two flags written once; per
    agent its predictions (means, inverse covariances, orientations, valid),
    sizes, current obstacles and lane segments, the weights and speeds."""
    per_row = ((7 + 2 * boundary) * n1 + 6 + 15) * itemsize + 3 + 4 + 2
    per_agent = (n_slots * horizon * (7 * itemsize + 1) + n_slots * 2 * itemsize
                 + n_obstacles * (2 * itemsize + 1) + n_segments * (4 * itemsize + 1)
                 + 15 * itemsize)
    return n_agents * n_rows * per_row + n_agents * per_agent


@contextlib.contextmanager
def _stages_twin_in_programs():
    """The programs' stages after the rollout as the plain twin (the
    parent's), to count and time them as they were: `planner.core`'s name is
    rebound, compiled entries are dropped on the way in and out."""
    from frenetix_tpu_torch.planner import core

    compiled.clear_all()
    core.cycle_stages = core.cycle_stages_plain
    try:
        yield
    finally:
        core.cycle_stages = _CYCLE_STAGES
        compiled.clear_all()


def _k3_against_twin(got, want, ro, ctx, dt):
    """K3's stages against `cycle_stages_plain`'s: (the flags, steps, harms
    and jerk terms that differ bitwise, per term the largest |Δ| over the
    size of what the term adds up (|term|, and for path length and velocity
    the same sums of |v| besides), that of the total, the agents whose
    masked argmin picks differently)."""
    from frenetix_tpu_torch.ops import costs

    def bits(t):
        t = t.contiguous()
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64) \
            if t.dtype.is_floating_point else t

    differ = [name for name in ("collides", "boundary_step", "boundary_harm", "selectable")
              if not torch.equal(bits(got[name]), bits(want[name]))]
    differ += [f"cost_terms[{k}]" for k in (2, 3, 12)
               if not torch.equal(bits(got["cost_terms"][..., k]),
                                  bits(want["cost_terms"][..., k]))]
    scale = want["cost_terms"].abs()
    scale[..., 5] += costs.simpson_uniform(ro.v.abs(), dt)
    scale[..., 8] += ro.v.abs().mean(-1)
    def ratio(err, size):
        # 0 where both are 0, inf where only the size is
        return torch.where(size > 0, err / size, torch.where(err > 0, torch.inf, 0.0))

    rel = ratio((got["cost_terms"] - want["cost_terms"]).abs(), scale).flatten(0, -2).amax(0)
    cost_scale = (scale * ctx.weights.abs()).sum(-1)
    cost_rel = float(ratio((got["cost"] - want["cost"]).abs(), cost_scale).max())
    big = torch.full_like(want["cost"], 1e15)
    pick_got = torch.argmin(torch.where(got["selectable"], got["cost"], big), -1)
    pick_want = torch.argmin(torch.where(want["selectable"], want["cost"], big), -1)
    return differ, rel.tolist(), cost_rel, int((pick_got != pick_want).sum())


def phase_cycle_kernel(dev, smi, floor_ms, counts=None):
    """Phase 23, kernel K3: (a) against the plain stages at the dense,
    batched and device-run shapes, (b) its time, the twin's and the bound,
    (c) launches on every main path against K2's, (d) kernels per replay of
    the programs with the plain stages and with K3."""
    from frenetix_tpu_torch.planner import core

    shapes = {}
    for dtype in (torch.float32, torch.float64):
        matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(dev, dtype)
        matrices, masks, ctx_b, _, _, _ = stacked_cycle_problem(
            A_BATCH, dev, dtype, m_bucket=M_BATCH, spread=12.0, ragged=True, o_slots=O_SLOTS)
        for what, m, mk, c in (("dense", matrix, mask, ctx), ("batched", matrices, masks, ctx_b)):
            ro = rollout_candidates(m, c.ref, c.veh, dt=dt, n_steps=n_steps, low_vel_mode=False,
                                    x0_orientation=c.x0_orientation,
                                    extra_ref_tables=c.corridor, table_window=768)
            shapes[(what, dtype)] = ((ro, mk, c), dict(dt=dt, check_boundary=True,
                                                        compensated_sum=False))
    ds = _device_sim("convoy", dev)
    for (args, kw), mode in zip(_recorded_calls(ds, 2, "cycle_stages"), ("", " low_vel")):
        shapes[(f"device run{mode}", torch.float32)] = (args, kw)
    results = {}
    for (what, dtype), (args, kw) in shapes.items():
        ro, mask, ctx = args
        before = host_count("kernel.k3.launches")
        got = core.cycle_stages(*args, **kw)
        check(host_count("kernel.k3.launches") == before + 1, f"K3 {what}: not one launch")
        want = core.cycle_stages_plain(*args, **kw)
        torch.cuda.synchronize()
        differ, rel, cost_rel, picks = _k3_against_twin(got, want, ro, ctx, kw["dt"])
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        name = str(dtype).split(".")[-1]
        check(not differ, f"K3 {what} {name}: {differ} differ from the twin bitwise")
        check(max(rel) <= rtol and cost_rel <= rtol,
              f"K3 {what} {name}: summed terms {max(rel):.3e}, total {cost_rel:.3e} beyond "
              f"{rtol} of their size")
        lead = tuple(ro.x.shape[:-2])
        n_agents, (n_rows, n1) = math.prod(lead), tuple(ro.x.shape[-2:])
        ms = cuda_ms(lambda: core.cycle_stages(*args, **kw), 20, 5)
        plain_ms = cuda_ms(lambda: core.cycle_stages_plain(*args, **kw), 3, 5)
        preds = ctx.preds
        floor = k3_bytes(n_rows, n1, ro.x.element_size(), n_agents,
                         preds.means.shape[-3], preds.means.shape[-2],
                         ctx.obstacle_xy.shape[-2], ctx.lane_segments.shape[-3],
                         kw["check_boundary"])
        bound = max(floor / HBM_BYTES_PER_S * 1e3, floor_ms)
        results[(what, dtype)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, floor_bytes=floor, rows=n_agents * n_rows,
            n1=n1, slots=preds.means.shape[-3], max_rel=max(rel), cost_rel=cost_rel,
            picks_differ=picks, collides_share=float(want["collides"].float().mean()))
        phase(23, f"(a, b) K3 {what} {name} rows={n_agents * n_rows} N+1={n1} "
                  f"O={preds.means.shape[-3]} S={ctx.lane_segments.shape[-3]}: flags, steps, "
                  f"harms and jerk terms bitwise equal to the plain stages; summed terms "
                  f"within {max(rel):.2e} of their size (per term "
                  f"{' '.join(f'{r:.1e}' for r in rel)}), total {cost_rel:.2e}; "
                  f"{picks} of {n_agents} picks differ (ties); collides "
                  f"{results[(what, dtype)]['collides_share']:.3f} of rows; K3 {ms:.4f} ms, "
                  f"plain stages {plain_ms:.4f} ms ({plain_ms / ms:.1f}x); bound "
                  f"max({floor / 1e6:.2f} MB at 3.35 TB/s, the launch floor) {bound:.4f} ms "
                  f"= {bound / ms:.3f} of K3's time [{smi}]")

    if counts is None:
        with _plain_spy() as spy:
            counts = _k2_paths(dev, smi, spy)
    for path, c in counts.items():
        phase(23, f"(c) {path}: K3 {c['k3']} launches = K2 {c['k2']} launch pairs [{smi}]")

    # (d) kernels per replay, with the plain stages (the parent's program) and K3
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(dev, torch.float32)
    matrices, masks, ctx_b, _, _, _ = stacked_cycle_problem(
        A_BATCH, dev, torch.float32, m_bucket=M_BATCH, spread=12.0, ragged=True)
    programs = {}
    for label, ctxm in (("twin", _stages_twin_in_programs), ("K3", contextlib.nullcontext)):
        with ctxm():
            compiled.clear_all()
            dense = _kernels_per_call(lambda: evaluate_cycle(
                matrix, mask, ctx, dt=dt, n_steps=n_steps, low_vel_mode=False), 10)
            fn = batched_full_cycle(dt=dt, n_steps=n_steps)
            fn.clear()
            batched = _kernels_per_call(lambda: fn(matrices, masks, ctx_b), 10)
            run = _device_sim("convoy", dev)
            device_run = _kernels_per_call(lambda: run.run(graph=True), 1, units=run.n_cycles)
            programs[label] = dict(dense=dense, batched=batched, device_run=device_run)
    for what in ("dense", "batched", "device_run"):
        (n0, b0), (n1_, b1) = programs["twin"][what], programs["K3"][what]
        phase(23, f"(d) {what} program replayed, per {'cycle' if what == 'device_run' else 'call'}"
                  f": {n0:.0f} -> {n1_:.0f} kernels, device busy {b0:.3f} -> {b1:.3f} ms "
                  f"(profiled; plain stages -> K3) [{smi}]")
    return results, counts, programs


def _leaves(tree):
    leaves = []
    compiled._flatten(tree, leaves)
    return leaves


def _print_compiled(what, runs, smi, detail):
    e, c, r = runs["eager"], runs["compiled"], runs["replayed"]
    phase(20, f"{what}: {e['res'].steps} steps, compiled = eager ({detail}), K1 "
              f"{c['k1']} = {r['k1']} = {e['k1']}; {c['captures']} captures in "
              f"{c['capture_s']:.3f} s; ms per cycle: eager {e['ms']:.3f}, compiled "
              f"run with captures {c['ms']:.3f}, replaying {r['ms']:.3f} [{smi}]")


def _timed(fn, *args):
    """`fn(*args)`, then a line with its seconds on the host clock."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[timing] {fn.__name__} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    dev, name, smi = phase_device()
    _timed(phase_build)
    k1_times, max_err = _timed(phase_k1, dev, smi)
    launches = Launches()
    _timed(phase_dense_cycle, dev, smi, launches)
    _timed(phase_simulation, dev, smi, launches)
    batched_p50 = _timed(phase_batched_cycle, dev, smi, launches)
    host_runs = _timed(phase_multiagent, dev, smi, launches)
    _timed(phase_risk, dev, smi, launches)
    # phase 21 runs here: phase 20's deliberately failed capture (i) leaves
    # the shared graph pool recording, so no capture may follow it
    q_times, q_launches = _timed(phase_quadrature, dev, smi, k1_times[
        (torch.float32, R_ROWS, P_DENSE)]["launch_floor_ms"])
    k2_times, k2_paths, k2_programs = _timed(phase_rollout, dev, smi, k1_times[
        (torch.float32, R_ROWS, P_DENSE)]["launch_floor_ms"])
    k3_times, _, k3_programs = _timed(phase_cycle_kernel, dev, smi, k1_times[
        (torch.float32, R_ROWS, P_DENSE)]["launch_floor_ms"], k2_paths)
    host_resp = _timed(phase_responsibility, dev, smi, launches, batched_p50)
    host_occ = _timed(phase_occlusion, dev, smi, launches)
    device_runs = _timed(phase_device_run, dev, smi, launches, host_runs)
    _timed(phase_fleet, dev, smi, launches)
    _timed(phase_behavior, dev, smi, launches)
    _timed(phase_device_post, dev, smi, launches, host_resp, host_occ)
    cli = _timed(phase_cli, dev, smi, launches)
    _timed(phase_walenet, dev, smi, launches)
    _timed(phase_mesh, dev, smi, launches, batched_p50, device_runs)
    _timed(phase_plots, dev, smi, launches, cli)
    _timed(phase_surface, dev, smi, launches)
    _timed(phase_compiled, dev, smi, launches)
    dense = k1_times[(torch.float32, R_ROWS, P_DENSE)]
    q_near, q_open = (q_times[(s, torch.float32)] for s in ("near", "open"))
    stacked = k1_times[(torch.float32, A_BATCH * R_ROWS, A_BATCH * M_BATCH * 31)]
    sim_sized = k1_times[(torch.float32, R_ROWS, P_SIM)]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "table_interp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": sum(launches.by_path.values()),
        "max_abs_err": max_err,
        "ms": dense["ms"], "plain_ms": dense["plain_ms"],
        "bound_ms": dense["bound_ms"], "bound_by": dense["bound_by"],
        # the nearest single call, grid_sample, which rounds the coordinate
        # and does not extend a segment for λ outside [0, 1): not the same
        # function
        "library_ms": dense["library_ms"],
        "library_call": "torch.nn.functional.grid_sample(bilinear, border, "
                        "align_corners=True) on a (1, C, 1, R) image",
        "library_max_abs_err": dense["library_max_abs_err"],
        "shape": f"R={R_ROWS} C={C_COLS} P={P_DENSE} float32",
        "launch_floor_ms": dense["launch_floor_ms"],
        "bound_with_floor_ms": dense["bound_with_floor_ms"],
        # a replayed path counts the launches recorded in its graph x replays
        "launches_by_path": launches.by_path,
        "sim_sized": dict(sim_sized, shape=f"R={R_ROWS} C={C_COLS} P={P_SIM} float32"),
        "stacked": dict(stacked, shape=f"R={A_BATCH * R_ROWS} C={C_COLS} "
                                       f"P={A_BATCH * M_BATCH * 31} float32"),
    }, {
        "name": "risk_quadrature", "route": "cuda", "source": Q_SOURCE,
        "replaces": None,   # the JAX package leaves the quadrature to XLA
        # on the batched convoy path, one per call
        "launches": q_launches,
        "max_abs_err": max(r["max_abs_err"] for r in q_times.values()),
        "ms": q_near["ms"], "plain_ms": q_near["plain_ms"],
        "bound_ms": q_near["bound_ms"], "bound_by": q_near["bound_by"],
        "shape": f"B={A_BATCH} M={M_BATCH} O={O_SLOTS} t=30 float32, near",
        "open": dict(q_open, shape=f"B={A_BATCH} M={M_BATCH} O={O_SLOTS} t=30 float32"),
        "float64": {s: q_times[(s, torch.float64)] for s in ("near", "open")},
    }, {
        "name": "rollout", "route": "cuda", "source": K2_SOURCE,
        "replaces": None,   # the JAX package leaves the rollout to XLA's fusion
        "launches": sum(c["k2"] for c in k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": 0.0,     # bitwise equal to the plain twin, every field
        **{k: k2_times[("dense", torch.float32)][k] for k in ("ms", "plain_ms", "bound_ms")},
        "shape": f"M={k2_times[('dense', torch.float32)]['rows']} N+1=31 float32, dense",
        "shapes": {f"{w} {str(d).split('.')[-1]}": r for (w, d), r in k2_times.items()},
        "kernels_per_replay": {label: {w: n for w, (n, _) in p.items()}
                               for label, p in k2_programs.items()},
    }, {
        "name": "cycle", "route": "cuda", "source": K3_SOURCE,
        "replaces": None,   # the JAX package leaves these stages to XLA's fusion
        "launches": sum(c["k3"] for c in k2_paths.values()),
        "launches_by_path": {p: c["k3"] for p, c in k2_paths.items()},
        "max_rel_err": max(r["max_rel"] for r in k3_times.values()),
        **{k: k3_times[("dense", torch.float32)][k] for k in ("ms", "plain_ms", "bound_ms")},
        "shape": f"M={k3_times[('dense', torch.float32)]['rows']} N+1=31 float32, dense",
        "shapes": {f"{w} {str(d).split('.')[-1]}": r for (w, d), r in k3_times.items()},
        "kernels_per_replay": {label: {w: n for w, (n, _) in p.items()}
                               for label, p in k3_programs.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
