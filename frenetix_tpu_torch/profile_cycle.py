"""Where a cycle's time goes on the card: kernels per call, device busy time,
idle share and the heaviest kernels, from `torch.profiler`.

    python -m frenetix_tpu_torch.profile_cycle [--calls 10] [--top 8]

Profiles, in float32 on the CUDA device, each over `--calls` calls after a
warm-up: the dense cycle (34,816 candidates), one simulation-sized cycle
(M = 1024), the batched cycle of 8 agents (A = 8, M = 1024) and the risk
stack on a simulation-sized rollout (4 obstacles), each eager
(`utils.compiled.disable_compiled()`) and compiled (the program captured in
the warm-up and replayed, with its input copies and output clones), and the
batched cycle at 16 obstacle slots alone, with the responsibility term
(reach grids) and with the occlusion gate and its soft costs (phantom
masks, occluder geometry), also each eager and compiled.  Then the body of the device-resident run (`parallel.device_sim`): the first
`--run-cycles` cycles of the convoy of 8 agents, as the eager loop and as the
replayed CUDA graph, reported per cycle; then the same with the behavior
planner, whose body adds the in-run FSM and the quintic stopping program,
with the responsibility term 0.2, and gated (the occlusion module with occ_um
and occ_ve, and the visible-area sensor stage).  For the two post-pass
bodies the risk stack's collision-probability quadrature is profiled alone
on the calls one cycle makes, and its share of the replayed body's busy time
is printed.  Last the Wale-Net net (`models.walenet`), eager and compiled,
at B = 1 and 16 obstacles on a synthetic export at the recorded widths
(`workloads.write_synthetic_walenet_onnx`, written to
build/walenet_synth.onnx), fed the convoy's preprocessed inputs.  The
profiler slows the host, so the wall time it reports per call is longer than an unprofiled
call's; device times per kernel are not affected.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from frenetix_tpu_torch import default_device
from frenetix_tpu_torch.io.scenario_factory import make_convoy
from frenetix_tpu_torch.models.walenet import WaleNet, _net_program
from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
from frenetix_tpu_torch.parallel.mesh import batched_full_cycle
from frenetix_tpu_torch.planner import reactive
from frenetix_tpu_torch.planner.core import evaluate_cycle
from frenetix_tpu_torch.risk import costs as risk_costs
from frenetix_tpu_torch.risk.probability import collision_probability_fast
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.compiled import disable_compiled
from frenetix_tpu_torch.utils.config import load_config
from frenetix_tpu_torch.workloads import (
    dense_cycle_problem, stacked_cycle_problem, stacked_post_pass_extras,
    write_synthetic_walenet_onnx,
)


def profile_calls(name, fn, calls, top, card, units=1, unit="call"):
    """Print one summary line and the `top` heaviest kernels of `fn`, per
    `unit`; one call of `fn` does `units` of them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    calls *= units
    wall_ms /= units
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_kernel.get(ev.name, (0, 0.0))
            by_kernel[ev.name] = (n + 1, us + ev.device_time)
    launches = sum(n for n, _ in by_kernel.values()) / calls
    busy_ms = sum(us for _, us in by_kernel.values()) / 1e3 / calls
    print(f"[profile] {name}: {launches:.0f} kernels per {unit}, device busy "
          f"{busy_ms:.3f} ms per {unit}, profiled wall {wall_ms:.3f} ms per {unit}, "
          f"idle share {1.0 - busy_ms / wall_ms:.2f} [{card}]")
    for kernel, (n, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"    {us / 1e3 / calls:8.4f} ms  {n / calls:6.1f}x  "
              f"{100.0 * us / 1e3 / calls / busy_ms:5.1f}%  {kernel[:90]}")
    return busy_ms


def profile_both(name, fn, calls, top, card):
    """`profile_calls` of `fn` eager (`disable_compiled()`) and compiled (its
    programs replayed as CUDA graphs, captured in the warm-up)."""
    with disable_compiled():
        profile_calls(f"{name}, eager", fn, calls, top, card)
    profile_calls(f"{name}, compiled (replayed CUDA graph)", fn, calls, top, card)


def _quadrature_calls(run):
    """The arguments of every collision-probability quadrature call of one
    eager run of `run` (a DeviceSimulation), and the calls per cycle."""
    calls = []
    original = risk_costs.collision_probability_fast

    def recording(*args):
        calls.append(args)
        return original(*args)

    risk_costs.collision_probability_fast = recording
    try:
        run.run(graph=False)
    finally:
        risk_costs.collision_probability_fast = original
    return calls, len(calls) // run.n_cycles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--run-cycles", type=int, default=10,
                    help="cycles of the device-resident run in each profiled run")
    args = ap.parse_args(argv)
    dev = default_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(dev, torch.float32)
    profile_both("dense cycle M=34816", lambda: evaluate_cycle(
        matrix, mask, ctx, dt=dt, n_steps=n_steps, low_vel_mode=False),
        args.calls, args.top, card)

    matrices, masks, sctx, ctxs, dt, n_steps = stacked_cycle_problem(
        8, dev, torch.float32, m_bucket=1024, spread=12.0, ragged=True)
    profile_both("simulation-sized cycle M=1024", lambda: evaluate_cycle(
        matrices[0], masks[0], ctxs[0], dt=dt, n_steps=n_steps, low_vel_mode=False),
        args.calls, args.top, card)
    batched = batched_full_cycle(dt=dt, n_steps=n_steps)
    profile_both("batched cycle A=8 M=1024", lambda: batched(matrices, masks, sctx),
                 args.calls, args.top, card)

    res = evaluate_cycle(matrices[0], masks[0], ctxs[0], dt=dt, n_steps=n_steps,
                         low_vel_mode=False)
    preds = ctxs[0].preds
    meta = meta_from_footprint(preds.lengths, preds.widths)
    # the planner's risk program (min_risk, log_risk): the stack and the total
    profile_both("risk stack M=1024 O=4", lambda: reactive._risk_program(
        res.rollout, preds, meta, mass=ctxs[0].veh.mass), args.calls, args.top, card)

    # the post-passes of the batched cycle, at the simulations' 16 slots
    matrices, masks, sctx, _, dt, n_steps = stacked_cycle_problem(
        8, dev, torch.float32, m_bucket=1024, spread=12.0, ragged=True, o_slots=16)
    grid, phantom_masks, geom = stacked_post_pass_extras(sctx)
    plain = batched_full_cycle(dt=dt, n_steps=n_steps)
    profile_both("batched cycle A=8 M=1024 O=16", lambda: plain(matrices, masks, sctx),
                 args.calls, args.top, card)
    with_resp = batched_full_cycle(dt=dt, n_steps=n_steps, resp_weight=0.2)
    profile_both("batched cycle with responsibility A=8 M=1024 O=16",
                 lambda: with_resp(matrices, masks, sctx, grid),
                 args.calls, args.top, card)
    gated = batched_full_cycle(dt=dt, n_steps=n_steps, occlusion=True,
                               occ_um_weight=2.0, occ_ve_weight=0.5)
    profile_both("gated batched cycle (occ_um, occ_ve) A=8 M=1024 O=16",
                 lambda: gated(matrices, masks, sctx, phantom_masks, *geom),
                 args.calls, args.top, card)

    # the body of the device-resident run: a whole run of a few cycles is one
    # call (reset, the cycles, the one fetch)
    for behavior in (False, True):
        config = load_config()
        config.dtype = "float32"
        config.simulation.start_multiagent = True
        config.behavior.use_behavior_planner = behavior
        sim = Simulation(make_convoy(), config, dev)
        sim.max_steps = args.run_cycles * config.planning.replanning_frequency
        run = DeviceSimulation(sim)
        if behavior and not run.fsm_in_scan:
            raise RuntimeError(f"the convoy's FSM is not in the run: {run.fsm_reason}")
        what = ", behavior (in-run FSM, stopping program)" if behavior else ""
        for graph, how in ((False, "eager"), (True, "replayed CUDA graph")):
            profile_calls(f"device-resident run, convoy A=8{what}, {how}",
                          lambda: run.run(graph=graph), max(args.calls // 5, 2),
                          args.top, card, units=run.n_cycles, unit="cycle")

    # the body with a post-pass: the responsibility term, and gated
    def responsibility(config):
        config.cost_weights["responsibility"] = 0.2

    def gated(config):
        config.occlusion.use_occlusion_module = True
        config.occlusion.harm_threshold = 0.02
        config.external_cost_weights["occ_um"] = 2.0
        config.external_cost_weights["occ_ve"] = 0.5
        config.prediction.calc_occlusions = True

    for what, setup in ((", responsibility 0.2", responsibility),
                        (", gated (occlusion module, occ_um, occ_ve, calc_occlusions)",
                         gated)):
        config = load_config()
        config.dtype = "float32"
        config.simulation.start_multiagent = True
        setup(config)
        sim = Simulation(make_convoy(), config, dev)
        sim.max_steps = args.run_cycles * config.planning.replanning_frequency
        run = DeviceSimulation(sim)
        busy = {}
        for graph, how in ((False, "eager"), (True, "replayed CUDA graph")):
            busy[graph] = profile_calls(
                f"device-resident run, convoy A=8{what}, {how}",
                lambda: run.run(graph=graph), max(args.calls // 5, 2), args.top, card,
                units=run.n_cycles, unit="cycle")
        calls, per_cycle = _quadrature_calls(run)
        first = calls[:per_cycle]
        rows = first[0][1].means.shape[-3]
        quad = profile_calls(
            f"collision-probability quadrature of one cycle{what} ({per_cycle} calls, "
            f"{rows} obstacle rows, window slots kept {len(run._runner.keep)} of "
            f"{config.prediction.max_obstacles})",
            lambda: [collision_probability_fast(*a) for a in first], args.calls,
            args.top, card, unit="cycle")
        print(f"[profile] quadrature share of the replayed body{what}: "
              f"{quad / busy[True]:.2f} ({quad:.3f} of {busy[True]:.3f} ms busy per "
              f"cycle) [{card}]")

    # the Wale-Net net, one call per obstacle batch
    os.makedirs("build", exist_ok=True)
    path = write_synthetic_walenet_onnx(os.path.join("build", "walenet_synth.onnx"))
    scenario = make_convoy(n_vehicles=16)
    ids = [ob.obstacle_id for ob in scenario.dynamic_obstacles]
    net = WaleNet(scenario, onnx_path=path, device=dev)
    for b in (1, 16):
        hist, nbrs, sc, _ = net._preprocess(ids[:b], 40)
        inputs = {k: torch.as_tensor(v, device=dev)
                  for k, v in (("hist", hist), ("nbrs", nbrs), ("sc_img", sc))}
        profile_both(f"Wale-Net net B={b} (synthetic export, recorded widths)",
                     lambda: _net_program(net._net, inputs["hist"], inputs["nbrs"],
                                          inputs["sc_img"]), args.calls, args.top, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
