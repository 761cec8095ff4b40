"""Rank functions for the mesh tests' torch.distributed worlds.

Each function runs in a spawned process of a gloo world on the CPU
(`frenetix_tpu_torch.parallel.distributed.run_world`): it imports torch and
the port only, never JAX, takes its inputs from NumPy `.npz` files or builds
them from the port's own seeded workloads, and returns NumPy results.
"""
from __future__ import annotations

import numpy as np
import torch

from frenetix_tpu_torch.utils import tracing

CPU = torch.device("cpu")
F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy()


def save_problem(path, matrices, masks, ctx_leaves: dict) -> None:
    """Write a stacked problem as flat NumPy arrays: `ctx_leaves` maps the
    CycleContext's field names to arrays, with `ref` and `preds` as dicts
    and `veh` as a sequence of floats."""
    flat = {"matrices": np.asarray(matrices), "masks": np.asarray(masks)}
    for name, value in ctx_leaves.items():
        if isinstance(value, dict):
            flat.update({f"{name}.{k}": np.asarray(v) for k, v in value.items()})
        else:
            flat[name] = np.asarray(value)
    np.savez(path, **flat)


def load_problem(path, device=CPU, dtype=F64):
    """(matrices, masks, the port's stacked CycleContext) from `save_problem`."""
    from frenetix_tpu_torch.geometry.refpath import RefPathTable
    from frenetix_tpu_torch.planner.core import context_from_numpy

    data = dict(np.load(path))
    leaves = {}
    for key, value in data.items():
        if "." in key:
            name, field = key.split(".")
            leaves.setdefault(name, {})[field] = value
        elif key not in ("matrices", "masks"):
            leaves[key] = value
    leaves["ref"] = RefPathTable(**leaves["ref"])
    ctx = context_from_numpy(**leaves, device=device, dtype=dtype)
    return (torch.as_tensor(data["matrices"], dtype=dtype, device=device),
            torch.as_tensor(data["masks"], device=device), ctx)


# the post-pass cases: 4 agents (2 or 1 per rank), every 9th of the stacked
# problem's 567 candidates, 5 obstacle slots (the risk stack on one CPU thread
# takes ~10 s per agent at the full 567 candidates and 16 slots)
POST_PASSES = dict(
    resp=dict(resp_weight=0.5),
    occl=dict(occlusion=True, occ_pm_weight=1.0, occ_um_weight=2.0, occ_ve_weight=0.5))


def post_pass_problem():
    """((matrices, masks, ctx, dt, n_steps), (grid, phantom masks, occluder
    geometry)) of the post-pass cases, float64 on the CPU."""
    from frenetix_tpu_torch import workloads

    m, k, ctx, _, dt, n = workloads.stacked_cycle_problem(4, CPU, F64, spread=12.0,
                                                          o_slots=5)
    return (m[:, :567:9], k[:, :567:9], ctx, dt, n), workloads.stacked_post_pass_extras(
        ctx, grid_n=32, n_rays=180)


def _out_np(out, poses):
    return {k: _np(v) for k, v in out.items()}, _np(poses)


def process_info_rank(rank, world):
    from frenetix_tpu_torch.parallel.distributed import process_info
    from frenetix_tpu_torch.parallel.scenario_sharding import host_info

    return process_info(), host_info()


def sharded_pipeline(rank, world, targets, logs_dir):
    """`run_sharded_pipeline` over `targets` at float32, sampling level 1:
    (agent, status) per row."""
    from frenetix_tpu_torch.parallel.scenario_sharding import run_sharded_pipeline
    from frenetix_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    cfg.debug.activate_logging = False
    results = run_sharded_pipeline(targets, cfg, logs_dir, device=CPU)
    return [(str(aid), st.name) for res in results for aid, st in res.agent_status.items()]


def sharded_cycles(rank, world, npz, dt, n_steps):
    """Every case of the sharded cycle in one world: the JAX tests' stacked
    problem over the whole world and over a mesh of the first two ranks, the
    responsibility and occlusion post-passes, and an agent count that does
    not divide over the world."""
    from frenetix_tpu_torch.parallel.mesh import (
        agent_rows, make_agent_mesh, sharded_full_cycle,
    )

    res = {}
    matrices, masks, ctx = load_problem(npz)
    mesh = make_agent_mesh()
    k1 = tracing.COUNTERS.get("kernel.k1.launches", 0)
    res["plain"] = _out_np(*sharded_full_cycle(mesh, dt=dt, n_steps=n_steps)(
        matrices, masks, ctx))
    res["launches"] = tracing.COUNTERS.get("kernel.k1.launches", 0) - k1
    res["mesh_size"] = mesh.size()
    # a mesh of the first two ranks: the others take its result
    sub = make_agent_mesh(2)
    res["sub"] = _out_np(*sharded_full_cycle(sub, dt=dt, n_steps=n_steps)(
        matrices, masks, ctx))

    (m_p, k_p, ctx_p, dt_p, n_p), (grid, pm, geom) = post_pass_problem()
    res["resp"] = _out_np(*sharded_full_cycle(
        mesh, dt=dt_p, n_steps=n_p, **POST_PASSES["resp"])(m_p, k_p, ctx_p, grid))
    res["occl"] = _out_np(*sharded_full_cycle(
        mesh, dt=dt_p, n_steps=n_p, **POST_PASSES["occl"])(m_p, k_p, ctx_p, pm, *geom))

    a_bad = world + 1 if world > 2 else 3
    try:
        sharded_full_cycle(mesh, dt=dt, n_steps=n_steps)(
            matrices[:a_bad], masks[:a_bad], agent_rows(ctx, 0, a_bad))
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


# ------------------------------------------------------- simulations on a mesh

HIGHWAY_STEPS = 80
OVERTAKE_STEPS = 150


def sim_config(batched=False, sharded=False, multi=True):
    """float64, level-1 sampling (`torch_parity.coarse_sampling`), with
    `start_multiagent` unless `multi` is False."""
    from frenetix_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.dtype = "float64"
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    cfg.simulation.start_multiagent = multi
    cfg.simulation.batched_device_agents = batched
    cfg.simulation.sharded_device_agents = sharded
    return cfg


def fleet_members(n=2):
    """Device runs of short highways with different lead gaps."""
    from frenetix_tpu_torch.io.scenario_factory import make_highway
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.sim.simulation import Simulation

    return [DeviceSimulation(Simulation(
        make_highway(lead_gap=40.0 + 5.0 * i, n_steps=HIGHWAY_STEPS),
        sim_config(multi=False), CPU)) for i in range(n)]


def host_result(res):
    """Statuses, steps and executed positions of a host SimulationResult."""
    return dict(status={aid: int(s) for aid, s in res.agent_status.items()},
                steps=res.steps,
                positions={aid: np.array([s.position for s in h])
                           for aid, h in res.histories.items()})


def device_result(dres):
    return dict(status=np.asarray(dres.status), steps=dres.steps,
                trajectories=dres.trajectories, selections=dres.selections,
                found=dres.found, k1_launches=dres.extras.get("k1_launches"),
                margins=[dres.extras.get(k) for k in ("margin_gap", "margin_rel")])


def sim_cases(rank, world, log_dir):
    """The sharded host run of the highway, the overtake through
    DeviceSimulation(mesh=world), a fleet of two highways split over the
    world (both also with `emit_margins`), and a fleet of three that does
    not divide over it."""
    from frenetix_tpu_torch.io.scenario_factory import make_highway, make_overtake
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, run_fleet
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh
    from frenetix_tpu_torch.sim.simulation import Simulation

    res = {}
    sim = Simulation(make_highway(n_steps=HIGHWAY_STEPS),
                     sim_config(batched=True, sharded=True), CPU, log_dir=log_dir)
    res["writes_logs"] = sim.log_dir is not None
    res["mesh_size"] = None if sim._batched_mesh is None else sim._batched_mesh.size()
    res["highway"] = host_result(sim.run())

    ds = DeviceSimulation(Simulation(make_overtake(n_steps=OVERTAKE_STEPS),
                                     sim_config(), CPU), mesh=make_agent_mesh())
    res["overtake"] = device_result(ds.run())
    res["overtake_margins"] = device_result(ds.run(emit_margins=True))

    fleet_mesh = make_agent_mesh(axis_name="scenarios")
    res["fleet"] = [device_result(d) for d in run_fleet(fleet_members(2), mesh=fleet_mesh)]
    res["fleet_margins"] = [device_result(d) for d in run_fleet(
        fleet_members(2), mesh=fleet_mesh, emit_margins=True)]
    try:
        run_fleet(fleet_members(3), mesh=fleet_mesh)
        res["fleet_of_three"] = None
    except ValueError as e:
        res["fleet_of_three"] = str(e)
    return res


def mesh_of_three(rank, world):
    """DeviceSimulation of the two-agent overtake on a mesh of three ranks:
    the error message (None when it did not raise)."""
    from frenetix_tpu_torch.io.scenario_factory import make_overtake
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh
    from frenetix_tpu_torch.sim.simulation import Simulation

    sim = Simulation(make_overtake(n_steps=OVERTAKE_STEPS), sim_config(), CPU)
    try:
        DeviceSimulation(sim, mesh=make_agent_mesh())
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------- every path of the device run

def _behavior_config(device_fsm):
    from frenetix_tpu_torch.utils.config import FrenetixConfig

    cfg = FrenetixConfig(dtype="float64")
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    cfg.behavior.use_behavior_planner = True
    cfg.behavior.device_fsm = device_fsm
    cfg.simulation.start_multiagent = True
    return cfg


def _walenet_config():
    from frenetix_tpu_torch.utils.config import FrenetixConfig

    cfg = FrenetixConfig(dtype="float64")
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    cfg.prediction.mode = "walenet"
    cfg.simulation.start_multiagent = True
    return cfg


def _post_pass_config(**kw):
    from frenetix_tpu_torch.utils.config import FrenetixConfig
    from tests.torch_parity import post_pass_config

    return post_pass_config(FrenetixConfig, **kw)


# name: (scenario, config, steps the run is cut to or None); two agents each
DEVICE_PATHS = {
    "in-run FSM": (lambda f: f.make_convoy(n_vehicles=1, length=300.0, n_steps=120),
                   lambda: _behavior_config("auto"), None),
    "hybrid behavior": (lambda f: f.make_convoy(n_vehicles=1, length=300.0, n_steps=120),
                        lambda: _behavior_config("hybrid"), None),
    "hybrid walenet": (lambda f: f.make_highway(n_steps=60), _walenet_config, None),
    "responsibility": (lambda f: f.make_highway(n_steps=200),
                       lambda: _post_pass_config(resp=0.5), 9),
    "occlusion module": (lambda f: _blind_spot(f),
                         lambda: _post_pass_config(module=True, vis=True), 9),
}


def _blind_spot(factory):
    from frenetix_tpu_torch.io import commonroad
    from tests.torch_parity import blind_spot

    return blind_spot(factory, commonroad)


def device_paths(rank, world, names, onnx_dir):
    """Each named path of `DEVICE_PATHS` solo and on a mesh of the whole
    world: {name: (solo result, sharded result, in-run FSM flag)}."""
    from frenetix_tpu_torch.io import scenario_factory
    from frenetix_tpu_torch.models import walenet
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.parallel.mesh import make_agent_mesh
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.workloads import write_synthetic_walenet_onnx

    walenet.WALENET_ONNX_PATH = write_synthetic_walenet_onnx(
        f"{onnx_dir}/walenet_rank{rank}.onnx", conv1=4, conv2=3, embed=4, enc=6,
        nbr_feat=5, scene_feat=3, dec=7)
    mesh = make_agent_mesh()
    out = {}
    for name in names:
        make, config, steps = DEVICE_PATHS[name]
        runs = []
        for m in (None, mesh):
            sim = Simulation(make(scenario_factory), config(), CPU)
            if steps is not None:
                sim.max_steps = steps
            ds = DeviceSimulation(sim, mesh=m)
            runs.append(device_result(ds.run()))
        out[name] = (*runs, ds.fsm_in_scan)
    return out


def assert_sharded_equals_solo(sharded, solo, what):
    """Two agents; the JAX device test's tolerances: statuses, steps and
    `found` equal, selections rtol 1e-12 / atol 1e-15, trajectories 1e-9."""
    assert len(solo["status"]) == 2, what
    assert sharded["steps"] == solo["steps"], what
    np.testing.assert_array_equal(sharded["status"], solo["status"], err_msg=what)
    np.testing.assert_array_equal(sharded["found"], solo["found"], err_msg=what)
    np.testing.assert_allclose(sharded["selections"], solo["selections"], rtol=1e-12,
                               atol=1e-15, err_msg=what)
    np.testing.assert_allclose(sharded["trajectories"], solo["trajectories"], atol=1e-9,
                               err_msg=what)
