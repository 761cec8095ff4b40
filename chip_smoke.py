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
   equal.  Times both with CUDA events.
4. dense cycle: the bench problem (34,816 candidates, 4 obstacles,
   corridor) through planner.core.evaluate_cycle on the card in float32;
   `found` must hold, the kernel must have launched, and best_idx must equal
   the CPU float64 run's (or the two costs lie within 4 float32 ulps).
5. simulation: run_scenario on the highway and overtake families on the
   card at float32; every agent must reach its goal through the kernel.

Then the kernels' JSON line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises, and the script exits
non-zero without printing the last line.  It needs no network and starts
no process that outlives it (nvcc and nvidia-smi run to completion).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from frenetix_tpu_torch.ops import _kernels, table_interp
from frenetix_tpu_torch.planner.core import evaluate_cycle
from frenetix_tpu_torch.run_scenario import run_scenarios
from frenetix_tpu_torch.utils.config import load_config
from frenetix_tpu_torch.workloads import dense_cycle_problem

KERNEL_SOURCE = "frenetix_tpu_torch/csrc/table_interp.cu"
REPLACES = "frenetix_tpu/ops/pallas_interp.py:34"
R_ROWS, C_COLS, P_DENSE = 868, 7, 1_079_296
P_SIM = 1024 * 31      # level-2 sampling of the simulations, padded
ULPS = 4


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


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


def phase_k1(dev, smi):
    rng = np.random.default_rng(0)
    results = {}
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for p in (P_DENSE, P_SIM, 1_000_003):
            table = torch.as_tensor(rng.normal(size=(R_ROWS, C_COLS)) * 50.0,
                                    dtype=dtype, device=dev)
            gidx = torch.as_tensor(np.sort(rng.integers(0, R_ROWS - 1, p)),
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
            ms = cuda_ms(lambda: table_interp.interp_rows(table, gidx, lam), 50)
            plain_ms = cuda_ms(lambda: table_interp.interp_rows_plain(table, gidx, lam), 50)
            results[(dtype, p)] = (ms, plain_ms)
            phase(3, f"K1 {str(dtype).split('.')[-1]} P={p}: bitwise equal, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                     f"(plain/kernel {plain_ms / ms:.2f}) [{smi}]")
    return results, max_err


def phase_dense_cycle(dev, smi):
    matrix, mask, ctx, dt, n_steps, n_valid = dense_cycle_problem(dev, torch.float32)
    check(matrix.shape == (34816, 13), f"dense matrix shape {tuple(matrix.shape)}")

    def cycle():
        return evaluate_cycle(matrix, mask, ctx, dt=dt, n_steps=n_steps,
                              low_vel_mode=False, check_boundary=True)

    before = table_interp.LAUNCHES
    res = cycle()
    best, found = int(res.best_idx), bool(res.found)
    check(found, "dense cycle found no selectable candidate")
    check(table_interp.LAUNCHES > before, "dense cycle did not launch K1")
    cost32 = res.cost.cpu().numpy()
    check(np.isfinite(cost32[mask.cpu().numpy()]).all(), "non-finite costs")
    check(np.isfinite(res.rollout.x.cpu().numpy()).all(), "non-finite positions")

    m64, k64, c64, *_ = dense_cycle_problem(torch.device("cpu"), torch.float64)
    ref = evaluate_cycle(m64, k64, c64, dt=dt, n_steps=n_steps, low_vel_mode=False,
                         check_boundary=True)
    best64 = int(ref.best_idx)
    cost64 = ref.cost.numpy()
    if best != best64:
        gap = abs(cost64[best] - cost64[best64])
        bound = ULPS * float(np.spacing(np.float32(abs(cost64[best64]))))
        check(gap <= bound, f"best_idx {best} (cuda f32) vs {best64} (cpu f64): "
                            f"f64 cost gap {gap} > {ULPS} float32 ulps ({bound})")
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


def phase_simulation(dev, smi):
    config = load_config()
    config.dtype = "float32"
    table_interp.reset_launches()
    t0 = time.perf_counter()
    results = run_scenarios(["highway", "overtake"], config, dev)
    wall = time.perf_counter() - t0
    launches = table_interp.LAUNCHES
    check(launches > 0, "the simulation did not launch K1")
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
             f"K1 launches {launches}")
    return launches, wall


def main() -> int:
    dev, name, smi = phase_device()
    phase_build()
    k1_times, max_err = phase_k1(dev, smi)
    phase_dense_cycle(dev, smi)
    launches, _ = phase_simulation(dev, smi)
    ms, plain_ms = k1_times[(torch.float32, P_DENSE)]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "table_interp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
