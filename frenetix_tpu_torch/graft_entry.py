"""The port's entry points: one full planning cycle, and a dry run of the mesh.

Twin of the JAX package's `__graft_entry__.py`:

- `entry()`: the full production cycle (`planner.core.evaluate_cycle` with
  road-boundary and corridor checking) as one callable with example
  arguments, on a synthetic problem: a 150 m arc as reference path, the
  sampling matrix padded to a multiple of 256 rows, 4 predicted obstacles
  ahead, a ±4 m corridor.
- `dryrun_multichip(n)`: an n-rank torch.distributed world (spawned
  processes: gloo on the CPU by default, NCCL with one card per rank for
  device "cuda") that runs the JAX dry run's three parts: two lockstep
  sharded steps of 2n agents with the executed poses all-gathered and turned
  into the second step's obstacle tensors on the device, a complete
  overtake through `DeviceSimulation(mesh=2 ranks)` equal to the solo run,
  and a fleet of n highway members split over the whole world.

    python -m frenetix_tpu_torch.graft_entry [--device cpu|cuda] [--ranks N]
"""
from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

from frenetix_tpu_torch import default_device
from frenetix_tpu_torch.geometry.refpath import prepare_reference_path
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.ops.sampling import (
    build_sampling_matrix, linspace_samples, pad_matrix, time_samples,
)
from frenetix_tpu_torch.planner.core import context_from_numpy, evaluate_cycle

__all__ = ["entry", "dryrun_multichip"]

N_STEPS = 30
DT = 0.1


def _synthetic_problem(m_candidates=512, n_ref=300, n_steps=N_STEPS):
    """The JAX entry's problem as NumPy float32 arrays (it is built in
    float32 there): (ref, matrix, mask, prediction fields)."""
    dtype = np.float32
    t = np.linspace(0, np.pi / 3, n_ref)
    center = np.stack([150 * np.sin(t), 150 * (1 - np.cos(t))], axis=1)
    ref = prepare_reference_path(center, extension=30.0, dtype=dtype)

    x0_lon = (40.0, 10.0, 0.0)
    x0_lat = (0.3, 0.0, 0.0)
    t1 = np.unique(np.concatenate([time_samples(1.1, 3.0, DT, 2), [n_steps * DT]]))
    lvl = 2
    while True:
        ss1 = np.union1d(linspace_samples(5.0, 15.0, lvl), [x0_lon[1]])
        d1 = np.union1d(linspace_samples(-3.0, 3.0, lvl), [x0_lat[0]])
        if len(t1) * len(ss1) * len(d1) >= m_candidates or lvl > 6:
            break
        lvl += 1
    matrix = build_sampling_matrix(t1_vals=t1, ss1_vals=ss1, d1_vals=d1,
                                   x0_lon=x0_lon, x0_lat=x0_lat, dtype=dtype)
    matrix, mask = pad_matrix(matrix, bucket=256)

    o = 4
    means = np.zeros((o, n_steps, 2), dtype)
    for k in range(o):
        s_obs = 55.0 + 10.0 * k + 8.0 * DT * np.arange(n_steps)
        means[k, :, 0] = np.interp(s_obs, ref.s, ref.xy[:, 0])
        means[k, :, 1] = np.interp(s_obs, ref.s, ref.xy[:, 1])
    covs = np.tile(np.eye(2, dtype=dtype) * 0.5, (o, n_steps, 1, 1))
    preds = dict(means=means, inv_covs=np.linalg.inv(covs).astype(dtype), covs=covs,
                 orientations=np.zeros((o, n_steps), dtype),
                 velocities=np.full((o, n_steps), 8.0, dtype),
                 lengths=np.full((o,), 4.5, dtype), widths=np.full((o,), 1.8, dtype),
                 valid=np.ones((o, n_steps), bool))
    return ref, matrix, mask, preds


def entry(device=None, dtype=torch.float32):
    """(fn, example_args): fn(matrix, mask, ctx) is the full planning cycle
    (boundary and corridor checking on: the production configuration), the
    example arguments the synthetic problem on `device` (the CUDA device by
    default) in `dtype`.  The problem is built in float32, as the JAX
    entry's, and then cast."""
    device = torch.device(device) if device is not None else default_device()
    ref, matrix, mask, preds = _synthetic_problem()
    weights = np.zeros(len(COST_TERM_ORDER), np.float32)
    for name, w in dict(lateral_jerk=0.2, longitudinal_jerk=0.2, velocity_offset=1.0,
                        distance_to_reference_path=5.0, prediction=0.2).items():
        weights[COST_TERM_ORDER.index(name)] = w
    corridor = np.empty((ref.s.shape[0], 2), np.float32)
    corridor[:, 0] = -4.0
    corridor[:, 1] = 4.0
    ctx = context_from_numpy(
        ref=ref, veh=VehicleParams(), weights=weights, preds=preds,
        obstacle_xy=preds["means"][:, 0], obstacle_valid=preds["valid"][:, 0],
        corridor=corridor, lane_segments=np.zeros((0, 2, 2), np.float32),
        lane_valid=np.zeros((0,), bool), x0_orientation=np.float32(0.27),
        desired_velocity=np.float32(12.0), desired_avg_velocity=np.float32(12.0),
        device=device, dtype=dtype)

    def fn(matrix, mask, ctx):
        return evaluate_cycle(matrix, mask, ctx, dt=DT, n_steps=N_STEPS,
                              low_vel_mode=False, check_boundary=True)

    return fn, (torch.as_tensor(matrix, dtype=dtype, device=device),
                torch.as_tensor(mask, device=device), ctx)


def _check(cond, what):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _dryrun_rank(rank, world, device_type, config, n_steps):
    """One rank of `dryrun_multichip`; returns its summary and K1 launches."""
    from frenetix_tpu_torch.io.scenario_factory import make_highway, make_overtake
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, run_fleet
    from frenetix_tpu_torch.parallel.mesh import (
        agent_pose_predictions, concat_obstacles, make_agent_mesh, sharded_full_cycle,
    )
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils import tracing
    from frenetix_tpu_torch.utils.config import load_config
    from frenetix_tpu_torch.workloads import stacked_cycle_problem

    device = default_device() if device_type == "cuda" else torch.device("cpu")
    k1_before = tracing.COUNTERS.get("kernel.k1.launches", 0)
    mesh = make_agent_mesh()
    a = 2 * world                     # two agents per rank
    n_cycle, dt = 10, 0.1
    # agents far apart laterally, so that their pose obstacles do not block
    # one another
    matrices, masks, ctx, _, _, _ = stacked_cycle_problem(
        a, device, torch.float32, n_steps=n_cycle, m_bucket=32, spread=60.0)
    step = sharded_full_cycle(mesh, dt=dt, n_steps=n_cycle)

    # step 1: the full cycle, the poses all-gathered over the mesh
    out, poses_all = step(matrices, masks, ctx)
    _check(tuple(poses_all.shape) == (a, 4), f"poses {tuple(poses_all.shape)}")
    _check(bool(out["found"].all()), "every agent must find a trajectory")

    # step 2: obstacle tensors rebuilt on the device from the gathered poses
    veh = ctx.veh
    agent_preds = agent_pose_predictions(
        poses_all, horizon=n_cycle, dt=dt, length=veh.length + 0.5,
        width=veh.width + 0.2, cov_pos=0.5)
    preds2 = concat_obstacles(ctx.preds, agent_preds)
    ctx2 = ctx._replace(preds=preds2, obstacle_xy=preds2.means[:, :, 0],
                        obstacle_valid=preds2.valid[:, :, 0])
    out2, poses_all2 = step(matrices, masks, ctx2)
    _check(tuple(poses_all2.shape) == (a, 4), "poses of step 2")
    _check(bool(out2["found"].all()), "step 2: the agents must still plan")

    def cfg64(multi=False):
        c = copy.deepcopy(config) if config is not None else load_config()
        c.dtype = "float64"
        c.simulation.start_multiagent = multi
        return c

    extra = {} if n_steps is None else {"n_steps": int(n_steps)}

    # a complete scenario through DeviceSimulation(mesh=2 ranks), equal to
    # the solo run
    mesh2 = make_agent_mesh(min(2, world))
    solo = DeviceSimulation(Simulation(make_overtake(**extra), cfg64(True),
                                       device)).run()
    sharded = None
    if mesh2.get_coordinate() is not None:
        sharded = DeviceSimulation(Simulation(make_overtake(**extra), cfg64(True),
                                              device), mesh=mesh2).run()
        _check(solo.steps == sharded.steps, f"steps {solo.steps} vs {sharded.steps}")
        _check(np.array_equal(solo.status, sharded.status), "statuses")
        _check(all(int(s) == 2 for s in sharded.status), f"status {sharded.status}")
        _check(float(np.abs(solo.trajectories - sharded.trajectories).max()) <= 1e-9,
               "overtake trajectories")

    # a scenario fleet split over the whole world
    fleet_mesh = make_agent_mesh(axis_name="scenarios")
    members = [DeviceSimulation(Simulation(
        make_highway(lead_gap=60.0 + 3.0 * i, **extra), cfg64(), device))
        for i in range(world)]
    fleet = run_fleet(members, mesh=fleet_mesh)
    _check(all(int(s) == 2 for r in fleet for s in r.status), "fleet statuses")
    solo_hw = DeviceSimulation(Simulation(make_highway(lead_gap=60.0, **extra),
                                          cfg64(), device)).run()
    _check(fleet[0].steps == solo_hw.steps, f"fleet member 0 steps {fleet[0].steps} "
                                            f"vs solo {solo_hw.steps}")
    summary = (
        f"dryrun_multichip OK: {world} ranks ({device_type}) — 2 lockstep sharded "
        f"steps ({a} agents, pose→obstacle feedback on the device, "
        f"best={out2['best'].tolist()}); complete overtake via "
        f"DeviceSimulation(mesh={mesh2.size()} ranks): {solo.steps} steps, statuses "
        f"{list(map(int, solo.status))} == solo; fleet of {world} highway scenarios "
        f"split over the world: all SUCCESS, member 0 steps {fleet[0].steps} == solo "
        f"{solo_hw.steps}")
    k1_launches = tracing.COUNTERS.get("kernel.k1.launches", 0) - k1_before
    return dict(summary=summary, k1_launches=k1_launches,
                sharded_steps=None if sharded is None else sharded.steps)


def dryrun_multichip(n_devices: int, device="cpu", *, config=None, n_steps=None,
                     timeout: float = 1200.0) -> list:
    """The JAX dry run on an `n_devices`-rank world of spawned processes:
    gloo ranks on the CPU, or NCCL ranks with one card each for device
    "cuda" (a host with fewer cards raises).  `config` replaces the default
    config of the scenarios (they run in float64, as the JAX dry run's) and
    `n_steps` shortens them.  Prints rank 0's summary and returns every
    rank's {"summary", "k1_launches", "sharded_steps"}."""
    from frenetix_tpu_torch.parallel.distributed import run_world

    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}, device='cuda') needs "
                           f"{n_devices} CUDA devices, this host has "
                           f"{torch.cuda.device_count()}")
    results = run_world(_dryrun_rank, n_devices, args=(device_type, config, n_steps),
                        device=device_type, timeout=timeout)
    print(results[0]["summary"], flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run's world (default: the CUDA "
                         "device count, or 2 on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    fn, example = entry(device)
    res = fn(*example)
    print(f"entry OK: best_idx {int(res.best_idx)} found {bool(res.found)}", flush=True)
    ranks = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 2)
    dryrun_multichip(ranks, device.type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
