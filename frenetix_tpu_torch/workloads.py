"""Replanning-cycle problems built without JAX, for timing and checks.

`dense_cycle_problem` is the port's counterpart of `bench.py::build_workload`
(the dense sampling sweep of BASELINE.json): a 60° arc of radius 150 m as
reference path (R = 868 rows at ds ≈ 0.25 m), a ±3.5 m drivable corridor,
4 predicted obstacles ahead, and the level-5 velocity/lateral grids, i.e.
34,320 candidates padded to M = 34,816, over N + 1 = 31 steps.

`stacked_cycle_problem` is the port's counterpart of
`bench_scaling.py::build_stacked_problem`: A agents on arcs shifted sideways,
±4 m corridors, one shared sampling matrix (7 × 9 × 9 = 567 candidates,
padded to the bucket), 4 predicted obstacles per agent, stacked along the
agent axis for `parallel.mesh.batched_full_cycle`.  With `ragged=True` the
agents' arcs differ in length, so their tables have different R and are
padded to a common one.  With `o_slots` the predictions are padded to that
many obstacle slots (the simulations' 16) and obstacle 0 of every agent
stands next to the candidates' end points, so that the risk stack has risk
to price; `stacked_post_pass_extras` makes the reach grids, phantom masks and
occluder geometry that the batched cycle's post-passes take.

`device_fleet` builds S device-resident simulations for
`parallel.device_sim.run_fleet`: members cycle through the highway, the
overtake with its lead as a second agent, the curve and the convoy of eight
agents, each with gaps and speeds drawn from a seed, so that no two members
are the same run.
"""
from __future__ import annotations

import numpy as np
import torch

from frenetix_tpu_torch.geometry.corridor import strip_corridor
from frenetix_tpu_torch.geometry.refpath import prepare_reference_path
from frenetix_tpu_torch.ops.sampling import (
    build_sampling_matrix, linspace_samples, pad_matrix, time_samples,
)
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.planner.core import context_from_numpy
from frenetix_tpu_torch.risk.reachable_set import ReachSetGrid

__all__ = ["dense_cycle_problem", "stacked_cycle_problem",
           "stacked_post_pass_extras", "device_fleet"]

N_STEPS = 30
DT = 0.1


def _dense_cycle_numpy(dtype=np.float32, density=5, bucket=1024):
    """Host arrays of the dense cycle: (matrix, mask, context fields), with
    the context fields named as `planner.core.context_from_numpy` takes them."""
    t = np.linspace(0, np.pi / 3, 600)
    center = np.stack([150 * np.sin(t), 150 * (1 - np.cos(t))], axis=1)
    ref = prepare_reference_path(center, extension=30.0, dtype=dtype)
    corridor = strip_corridor(ref, 3.5)

    x0_lon = (40.0, 10.0, 0.0)
    x0_lat = (0.3, 0.0, 0.0)
    t1 = np.unique(np.concatenate([time_samples(1.1, 3.0, DT, 2), [N_STEPS * DT]]))
    ss1 = np.union1d(linspace_samples(5.0, 15.0, density), [x0_lon[1]])
    d1 = np.union1d(linspace_samples(-3.0, 3.0, density), [x0_lat[0]])
    matrix = build_sampling_matrix(
        t1_vals=t1, ss1_vals=ss1, d1_vals=d1, x0_lon=x0_lon, x0_lat=x0_lat,
        dtype=dtype,
    )
    matrix, mask = pad_matrix(matrix, bucket=bucket)

    o, t_pred = 4, N_STEPS
    means = np.zeros((o, t_pred, 2), dtype)
    for k in range(o):
        s_obs = 55.0 + 12.0 * k + 8.0 * DT * np.arange(t_pred)
        means[k, :, 0] = np.interp(s_obs, ref.s, ref.xy[:, 0])
        means[k, :, 1] = np.interp(s_obs, ref.s, ref.xy[:, 1])
    covs = np.tile(np.eye(2, dtype=dtype) * 0.5, (o, t_pred, 1, 1))
    preds = dict(
        means=means,
        inv_covs=np.linalg.inv(covs).astype(dtype),
        covs=covs,
        orientations=np.zeros((o, t_pred), dtype),
        velocities=np.full((o, t_pred), 8.0, dtype),
        lengths=np.full((o,), 4.5, dtype),
        widths=np.full((o,), 1.8, dtype),
        valid=np.ones((o, t_pred), bool),
    )
    weights = np.zeros(len(COST_TERM_ORDER), dtype)
    for name, w in dict(
        lateral_jerk=0.2, longitudinal_jerk=0.2, velocity_offset=1.0,
        distance_to_reference_path=5.0, prediction=0.2,
    ).items():
        weights[COST_TERM_ORDER.index(name)] = w
    fields = dict(
        ref=ref,
        veh=VehicleParams(),
        weights=weights,
        preds=preds,
        obstacle_xy=means[:, 0],
        obstacle_valid=preds["valid"][:, 0],
        corridor=corridor,
        lane_segments=np.zeros((0, 2, 2), dtype),
        lane_valid=np.zeros((0,), bool),
        x0_orientation=np.asarray(0.27, dtype),
        desired_velocity=np.asarray(12.0, dtype),
        desired_avg_velocity=np.asarray(12.0, dtype),
    )
    return matrix, mask, fields


def dense_cycle_problem(device: torch.device, dtype=torch.float32, density=5,
                        bucket=1024):
    """(matrix, mask, ctx, dt, n_steps, n_valid) of the dense cycle on
    `device`, ready for `planner.core.evaluate_cycle`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    matrix, mask, fields = _dense_cycle_numpy(np_dtype, density, bucket)
    ctx = context_from_numpy(**fields, device=device, dtype=dtype)
    return (torch.as_tensor(matrix, dtype=dtype, device=device),
            torch.as_tensor(mask, device=device), ctx, DT, N_STEPS,
            int(mask.sum()))


def _pad_slots(arr, o_slots):
    """First axis zero-padded to `o_slots` rows."""
    pad = np.zeros((o_slots - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def _stacked_cycle_numpy(a: int, dtype=np.float32, n_steps: int = N_STEPS,
                         m_bucket: int = 256, spread: float = 3.0,
                         ragged: bool = False, o_slots=None):
    """Host arrays of the stacked problem: the shared (matrix, mask) and one
    dict of context fields per agent."""
    matrix = build_sampling_matrix(
        t1_vals=np.round(np.arange(1.1, 3.05, 0.3), 2),
        ss1_vals=np.linspace(5, 15, 9), d1_vals=np.linspace(-3, 3, 9),
        x0_lon=(30.0, 10.0, 0.0), x0_lat=(0.0, 0.0, 0.0), dtype=dtype,
    )
    matrix, mask = pad_matrix(matrix, m_bucket)

    o, t_pred = 4, n_steps
    weights = np.zeros(len(COST_TERM_ORDER), dtype)
    weights[COST_TERM_ORDER.index("velocity_offset")] = 1.0
    weights[COST_TERM_ORDER.index("distance_to_reference_path")] = 5.0

    agents = []
    for i in range(a):
        arc = np.pi / 3 * (1.0 + 0.04 * i) if ragged else np.pi / 3
        t = np.linspace(0, arc, 300)
        ref = prepare_reference_path(
            np.stack([150 * np.sin(t) + spread * i, 150 * (1 - np.cos(t))], axis=1),
            extension=20.0, dtype=dtype,
        )
        covs = np.tile(np.eye(2, dtype=dtype) * 0.5, (o, t_pred, 1, 1))
        means = np.tile(np.array([60.0 + spread * i, 5.0], dtype), (o, t_pred, 1))
        if o_slots is not None:
            # obstacle 0 next to the end points of the candidates' fan
            means[0] = np.array([40.0 + spread * i, 5.0], dtype)
        preds = dict(
            means=means, inv_covs=np.linalg.inv(covs).astype(dtype), covs=covs,
            orientations=np.zeros((o, t_pred), dtype),
            velocities=np.full((o, t_pred), 8.0, dtype),
            lengths=np.full((o,), 4.5, dtype), widths=np.full((o,), 1.8, dtype),
            valid=np.ones((o, t_pred), bool),
        )
        if o_slots is not None:
            preds = {k: _pad_slots(v, o_slots) for k, v in preds.items()}
            means = preds["means"]
        agents.append(dict(
            ref=ref, veh=VehicleParams(), weights=weights, preds=preds,
            obstacle_xy=means[:, 0], obstacle_valid=preds["valid"][:, 0],
            corridor=strip_corridor(ref, 4.0).astype(dtype),
            lane_segments=np.zeros((0, 2, 2), dtype),
            lane_valid=np.zeros((0,), bool),
            x0_orientation=np.asarray(0.2, dtype),
            desired_velocity=np.asarray(10.0, dtype),
            desired_avg_velocity=np.asarray(10.0, dtype),
        ))
    return matrix, mask, agents


def stacked_cycle_problem(a: int, device: torch.device, dtype=torch.float32,
                          n_steps: int = N_STEPS, m_bucket: int = 256,
                          spread: float = 3.0, ragged: bool = False, o_slots=None):
    """(matrices (A, M, 13), masks (A, M), stacked ctx, per-agent ctxs, dt,
    n_steps) on `device`: the stacked context for
    `parallel.mesh.batched_full_cycle` and the A single-agent contexts it
    was stacked from, for the sequential `planner.core.evaluate_cycle`."""
    from frenetix_tpu_torch.parallel.mesh import stack_cycle_contexts

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    matrix, mask, agents = _stacked_cycle_numpy(a, np_dtype, n_steps, m_bucket,
                                                spread, ragged, o_slots)
    ctxs = [context_from_numpy(**f, device=device, dtype=dtype) for f in agents]
    matrices = torch.as_tensor(np.tile(matrix[None], (a, 1, 1)), dtype=dtype,
                               device=device)
    masks = torch.as_tensor(np.tile(mask[None], (a, 1)), device=device)
    return matrices, masks, stack_cycle_contexts(ctxs), ctxs, DT, n_steps


def stacked_post_pass_extras(ctx, seed: int = 0, grid_n: int = 64, n_rays: int = 720,
                             n_points: int = 4):
    """The extras of the batched cycle's post-passes for a stacked context of
    `stacked_cycle_problem(..., o_slots=...)`, on its device:

    - an agent-stacked ReachSetGrid in which only obstacle 0 is valid and
      reaches the +y half of its grid at every step, so that the
      responsibility term differs between candidates;
    - phantom masks (A, O) marking obstacle 0;
    - occluder geometry: egos 25 m before obstacle 1, polar maps with ranges
      drawn from `seed` between 8 and 35 m, and `n_points` silhouette points
      around obstacle 0 of which the first two are valid.

    Returns (grid, phantom_masks, (ego, r_vis, pts, pts_valid))."""
    xy = ctx.preds.means[:, :, 0]                          # (A, O, 2)
    a, o = xy.shape[0], xy.shape[1]
    device, dtype = xy.device, xy.dtype
    occupancy = torch.zeros((a, o, 11, grid_n, grid_n), dtype=torch.bool, device=device)
    occupancy[:, 0, :, :, grid_n // 2:] = True
    first = torch.zeros((a, o), dtype=torch.bool, device=device)
    first[:, 0] = True
    grid = ReachSetGrid(origin=xy, occupancy=occupancy, valid=first,
                        cell=torch.full((a, o), 1.5, dtype=dtype, device=device),
                        dt_rs=0.2)
    rng = np.random.default_rng(seed)
    r_vis = torch.as_tensor(rng.uniform(8.0, 35.0, (a, n_rays)), dtype=dtype,
                            device=device)
    offsets = torch.as_tensor(rng.normal(size=(a, n_points, 2)), dtype=dtype,
                              device=device)
    pts_valid = torch.zeros((a, n_points), dtype=torch.bool, device=device)
    pts_valid[:, :2] = True
    ego = xy[:, 1] - torch.tensor([25.0, 3.0], dtype=dtype, device=device)
    return grid, first.clone(), (ego, r_vis, xy[:, :1] + offsets, pts_valid)


def device_fleet(n_members: int, device=None, dtype: str = "float32", seed: int = 0,
                 n_steps=None, config=None):
    """`n_members` DeviceSimulations for `parallel.device_sim.run_fleet`.

    Member i is of family i mod 4: highway (one agent), overtake with
    `start_multiagent` (two agents), curve (one agent), convoy with
    `start_multiagent` (eight agents).  Speeds and gaps vary around the
    factory's defaults by up to ±10 % (speeds) and ±15 % (gaps), drawn from
    `seed`.  `n_steps` shortens every scenario (a CPU rehearsal); `config`
    replaces the default config (its `dtype` and `start_multiagent` are set
    per member).  `device` as in `Simulation`: the CUDA device by default."""
    import copy

    from frenetix_tpu_torch.io import scenario_factory as factory
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils.config import load_config

    rng = np.random.default_rng(seed)
    extra = {} if n_steps is None else {"n_steps": int(n_steps)}
    sims = []
    for i in range(n_members):
        speed, gap = rng.uniform(0.9, 1.1), rng.uniform(0.85, 1.15)
        family = i % 4
        if family == 0:
            scenario = factory.make_highway(ego_v=15.0 * speed, lead_gap=40.0 * gap,
                                            **extra)
        elif family == 1:
            scenario = factory.make_overtake(ego_v=14.0 * speed, lead_gap=35.0 * gap,
                                             **extra)
        elif family == 2:
            scenario = factory.make_curve(ego_v=12.0 * speed, lead_v=8.0 * gap, **extra)
        else:
            scenario = factory.make_convoy(ego_v=10.0 * speed, gap=30.0 * gap, **extra)
        cfg = copy.deepcopy(config) if config is not None else load_config()
        cfg.dtype = dtype
        cfg.simulation.start_multiagent = family in (1, 3)
        sims.append(DeviceSimulation(Simulation(scenario, cfg, device)))
    return sims
