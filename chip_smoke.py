#!/usr/bin/env python3
"""Smoke run of the PyTorch port (frenetix_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each printed on lines of its own:

1. device: a CUDA device must exist and be Hopper (compute capability 9.x);
   prints the card's name and power limit; TF32 is switched off.
2. build: compiles the K1 kernel (csrc/table_interp.cu) with nvcc.
3. K1 against its plain PyTorch twin on the card, at the dense cycle's
   shapes (R = 868, C = 7, P = 1,079,296), at the simulations' P = 1024 x 31
   and at a ragged P, in float32 and float64: the outputs must be bitwise
   equal.  Times both with CUDA events, and an empty kernel launched the
   same way: the floor of one launch, which bounds K1 at small P.
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
   on the card (equal statuses and step counts) and the CPU float64 run.
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

13. behavior planner (float64 for the hard checks, float32 reported beside):
   (a) the host path, one agent: traffic_light, stop_sign and lane_change in
   float32 and float64 on the card; the float64 run must equal the CPU
   float64 run of the port (statuses, steps, positions within 1e-6 m);
   (b) the convoy with behavior, host batched against host sequential on the
   card: equal statuses, positions within 1e-4 m up to the first retirement;
   (c) the device-resident run with the FSM in the run on traffic_light,
   stop_sign, yield_sign, crosswalk and convoy: float32 eager and replayed
   (bitwise equal, one fetch, sync debug mode "error"), then float64 equal
   to the hybrid run and the host sequential run (statuses, steps, positions
   within 1e-6 m); ms per cycle eager and replayed, capture time;
   (d) hybrid: lane_change falls back at construction, behavior_overtake
   bails at run time; both equal the forced "hybrid" run (float64); ms per
   cycle, fetches and captures per run;
   (e) a behavior fleet of traffic_light, stop_sign and convoy (float32,
   FSM in the run) against the members' solo runs; scenarios per second and
   peak memory.

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

Each path (phases 4 to 15) is driven with K1's launch count set to 0 just
before and read just after; a path that launched no kernel fails the run.
Then the kernels' JSON line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises, and the script exits
non-zero without printing the last line.  It needs no network and starts
no process that outlives it (nvcc and nvidia-smi run to completion).
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import sqlite3
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.io.commonroad import Obstacle, State
from frenetix_tpu_torch.ops import _kernels, table_interp
from frenetix_tpu_torch.ops.kinematics import rollout_candidates
from frenetix_tpu_torch.parallel import device_sim
from frenetix_tpu_torch.parallel.mesh import batched_full_cycle
from frenetix_tpu_torch.planner import reactive
from frenetix_tpu_torch.planner.core import evaluate_cycle
from frenetix_tpu_torch.risk import reachable_set
from frenetix_tpu_torch.risk.costs import trajectory_risks
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch import run_scenario
from frenetix_tpu_torch.ops.vehicle_db import resolve_vehicle
from frenetix_tpu_torch.run_scenario import run_scenarios
from frenetix_tpu_torch.sim import visible_area
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import load_config
from frenetix_tpu_torch.utils.sim_logging import require_strict_tables
from frenetix_tpu_torch.workloads import (
    dense_cycle_problem, device_fleet, stacked_cycle_problem, stacked_post_pass_extras,
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
    t0 = time.perf_counter()
    _kernels.load_library("table_interp")
    info = _kernels.build_info("table_interp")
    phase(2, f"K1 built={info['built']} nvcc_s={info['seconds']:.2f} "
             f"load_s={time.perf_counter() - t0:.2f} lib={info['library']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
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


class Launches:
    """K1's launch count per driven path: set to 0 just before the path,
    read just after; a path that launched no kernel fails."""

    def __init__(self):
        self.by_path = {}

    def start(self):
        table_interp.reset_launches()

    def stop(self, path, replayed=None):
        """`replayed`: the path replays a CUDA graph, which the counter does
        not see (it counted the launches recorded at capture); the path's
        launches are then the run's own figure, recorded × replays."""
        n = table_interp.LAUNCHES
        check(n > 0, f"{path} launched K1 no time")
        self.by_path[path] = n if replayed is None else replayed
        return self.by_path[path]


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

    before = table_interp.LAUNCHES
    p50, lo, hi = timed_calls(lambda: fn(matrices, masks, ctx))
    check(table_interp.LAUNCHES - before == 23, "one K1 launch per batched call")

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
        _, ref = _multiagent_run(family, torch.device("cpu"), "float64", batched=True)
        end, end_seq, end_ref = (_end_positions(r) for r in (res, seq, ref))
        dev_seq = max(float(np.abs(end[a] - end_seq[a]).max()) for a in end)
        dev_ref = max(float(np.abs(end[a] - end_ref[a]).max()) for a in end)
        phase(7, f"{family}: sequential on the card: equal statuses and steps "
                 f"({seq.steps}), K1 launches {seq_launches}, wall "
                 f"{seq.wall_time:.3f} s, max end-position deviation {dev_seq:.3e} m; "
                 f"cpu f64 batched: steps {ref.steps}, success {ref.success}, max "
                 f"end-position deviation {dev_ref:.3e} m [{smi}]")
        runs[family] = (res, seq)
    return runs


def _risk_problem(device, dtype):
    """A simulation-sized rollout problem for the risk stack: the stacked
    problem's first agent (M = 1024, 4 obstacles), with the obstacles moved
    onto the agent's path so that the risks are not all 0."""
    matrices, _, _, ctxs, dt, n_steps = stacked_cycle_problem(
        1, device, dtype, m_bucket=M_BATCH, spread=12.0)
    ctx = ctxs[0]
    means = ctx.preds.means.clone()
    means[..., 0] = torch.tensor([52.0, 58.0, 64.0, 70.0], dtype=dtype,
                                 device=device)[:, None]
    means[..., 1] = torch.tensor([9.0, 11.5, 14.0, 17.5], dtype=dtype,
                                 device=device)[:, None]
    preds = ctx.preds._replace(means=means)

    def rollout():
        return rollout_candidates(
            matrices[0], ctx.ref, ctx.veh, dt=dt, n_steps=n_steps, low_vel_mode=False,
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
    # obstacle slots): its first steps only
    ref_steps = 12
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
    fetches = device_sim.FETCHES
    res = ds.run(graph=graph, sync_debug=True)
    check(device_sim.FETCHES == fetches + 1, "a device-resident run fetches once")
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


def phase_fleet(dev, smi, launches):
    for size in FLEET_SIZES:
        t0 = time.perf_counter()
        sims = device_fleet(size, dev, "float32")
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fetches = device_sim.FETCHES
        launches.start()
        t0 = time.perf_counter()
        results = device_sim.run_fleet(sims, sync_debug=True)
        wall = time.perf_counter() - t0
        n_k1 = results[0].extras["k1_launches"]
        launches.stop(f"fleet S={size}, replayed", replayed=n_k1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(device_sim.FETCHES == fetches + 1, "a fleet run fetches once")
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


def phase_behavior(dev, smi, launches):
    cpu = torch.device("cpu")
    # (a) the host path, one agent
    for family in ("traffic_light", "stop_sign", "lane_change"):
        runs = {}
        for dtype in ("float32", "float64"):
            launches.start()
            runs[dtype] = _behavior_sim(family, dev, dtype).run()
            launches.stop(f"behavior host {family}, {dtype}")
        ref = _behavior_sim(family, cpu, "float64").run()
        r64, r32 = runs["float64"], runs["float32"]
        check(r64.success and _statuses(r64) == _statuses(ref) and r64.steps == ref.steps,
              f"behavior {family}: card f64 {r64.agent_status} steps {r64.steps} vs cpu "
              f"f64 {ref.agent_status} steps {ref.steps}")
        gap64 = _history_gap(r64, ref)
        check(gap64 <= BEH_POS_TOL, f"behavior {family}: card f64 {gap64} m from cpu f64")
        gap32 = _history_gap(r32, ref)
        phase(13, f"(a) behavior host {family}: card f64 = cpu f64 (steps {r64.steps}, "
                  f"success, positions within {gap64:.3e} m), wall {r64.wall_time:.3f} s; "
                  f"card f32: {[s.name for s in r32.agent_status.values()]} steps "
                  f"{r32.steps}, wall {r32.wall_time:.3f} s, gap to f64 over the common "
                  f"steps {gap32:.3e} m [{smi}]")

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
                  f"{1e3 * hyb.wall_time / c_n:.3f} ms per cycle [{smi}]")

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
    fetches = device_sim.FETCHES
    launches.start()
    t0 = time.perf_counter()
    results = device_sim.run_fleet(sims, sync_debug=True)
    wall = time.perf_counter() - t0
    launches.stop("behavior fleet S=3", replayed=results[0].extras["k1_launches"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(device_sim.FETCHES == fetches + 1, "a behavior fleet run fetches once")
    gap = 0.0
    for f, fleet_res, sim in zip(families, results, sims):
        solo = sim.run()
        check(np.array_equal(fleet_res.status, solo.status) and fleet_res.steps == solo.steps,
              f"behavior fleet member {f}: {fleet_res.status} steps {fleet_res.steps} vs "
              f"solo {solo.status} steps {solo.steps}")
        gap = max(gap, _dres_gap(fleet_res, solo))
    check(gap <= POS_TOL, f"behavior fleet members {gap} m from their solo runs")
    c_max = max(s.n_cycles for s in sims)
    phase(13, f"(e) behavior fleet S=3 ({', '.join(families)}), FSM in the run, replayed, "
              f"1 fetch: wall {wall:.3f} s with warm-up and capture "
              f"({results[0].extras['capture_s']:.3f} s), {3 / wall:.3f} scenarios/s, "
              f"{1e3 * wall / c_max:.3f} ms per cycle, peak memory {peak:.3f} GiB; every "
              f"member equals its solo run, positions within {gap:.3e} m [{smi}]")


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
    fetches = device_sim.FETCHES
    launches.start()
    t0 = time.perf_counter()
    results = device_sim.run_fleet(sims, sync_debug=True)
    wall = time.perf_counter() - t0
    launches.stop("responsibility fleet S=3", replayed=results[0].extras["k1_launches"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(device_sim.FETCHES == fetches + 1, "a responsibility fleet run fetches once")
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
        fetches = device_sim.FETCHES
        with spy.active():
            launches.start()
            _cli(["highway", "--multiagent", "--device-sim", "--evaluate",
                  "--logs", d["c"]], "(c)")
        check(device_sim.FETCHES == fetches + 1, "(c): a device run fetches once")
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
        fetches = device_sim.FETCHES
        with spy.active():
            launches.start()
            _cli(["highway", "overtake", "--device-fleet", "--evaluate",
                  "--logs", d["d"]], "(d)")
        check(device_sim.FETCHES == fetches + 1, "(d): a fleet run fetches once")
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


def main() -> int:
    dev, name, smi = phase_device()
    phase_build()
    k1_times, max_err = phase_k1(dev, smi)
    launches = Launches()
    phase_dense_cycle(dev, smi, launches)
    phase_simulation(dev, smi, launches)
    batched_p50 = phase_batched_cycle(dev, smi, launches)
    host_runs = phase_multiagent(dev, smi, launches)
    phase_risk(dev, smi, launches)
    host_resp = phase_responsibility(dev, smi, launches, batched_p50)
    host_occ = phase_occlusion(dev, smi, launches)
    phase_device_run(dev, smi, launches, host_runs)
    phase_fleet(dev, smi, launches)
    phase_behavior(dev, smi, launches)
    phase_device_post(dev, smi, launches, host_resp, host_occ)
    phase_cli(dev, smi, launches)
    dense = k1_times[(torch.float32, R_ROWS, P_DENSE)]
    stacked = k1_times[(torch.float32, A_BATCH * R_ROWS, A_BATCH * M_BATCH * 31)]
    sim_sized = k1_times[(torch.float32, R_ROWS, P_SIM)]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "table_interp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": sum(launches.by_path.values()),
        "max_abs_err": max_err,
        "ms": dense["ms"], "plain_ms": dense["plain_ms"],
        "bound_ms": dense["bound_ms"], "bound_by": dense["bound_by"],
        "library_ms": None,     # no one PyTorch call gathers two rows and lerps
        "shape": f"R={R_ROWS} C={C_COLS} P={P_DENSE} float32",
        "launch_floor_ms": dense["launch_floor_ms"],
        "bound_with_floor_ms": dense["bound_with_floor_ms"],
        # a replayed path counts the launches recorded in its graph x replays
        "launches_by_path": launches.by_path,
        "sim_sized": dict(sim_sized, shape=f"R={R_ROWS} C={C_COLS} P={P_SIM} float32"),
        "stacked": dict(stacked, shape=f"R={A_BATCH * R_ROWS} C={C_COLS} "
                                       f"P={A_BATCH * M_BATCH * 31} float32"),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
