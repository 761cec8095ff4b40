"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; outputs
come back as numpy arrays and are compared field by field.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

CPU = torch.device("cpu")

# Float fields: relative 1e-9 of the value, plus an absolute floor of 1e-10
# for entries that are zero on one side and round-off (~1e-16 of the
# neighbouring magnitudes) on the other.
RTOL = 1e-9
ATOL = 1e-10


def to_np(x):
    """numpy view of a torch tensor, a JAX array or a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t64(a):
    """float64 CPU tensor (bool arrays stay bool)."""
    a = np.array(a)
    if a.dtype == bool:
        return torch.as_tensor(a)
    return torch.as_tensor(a, dtype=torch.float64)


def assert_fields_match(jax_tuple, torch_tuple, fields=None, rtol=RTOL, atol=ATOL,
                        what=""):
    """Bool and integer fields equal, float fields within (rtol, atol);
    tuples of arrays (the rollout's `extras`) are compared entry by entry."""
    for f in fields or jax_tuple._fields:
        a, b = getattr(jax_tuple, f), getattr(torch_tuple, f)
        if a is None or b is None:
            assert a is None and b is None, f"{what}{f}: one side is None"
            continue
        if isinstance(a, tuple):
            a, b = np.stack([to_np(x) for x in a]), np.stack([to_np(x) for x in b])
        a, b = to_np(a), to_np(b)
        assert a.shape == b.shape, f"{what}{f}: shape {a.shape} vs {b.shape}"
        if a.dtype == bool or a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}{f}")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{what}{f}")


def curved_ref_np(n_points=600, radius=150.0, dtype=np.float64):
    """The bench's 60° arc (R = 868 rows at ds ≈ 0.25 m, above the 768-row
    window of the cycle)."""
    from frenetix_tpu.geometry.refpath import prepare_reference_path

    t = np.linspace(0, np.pi / 3, n_points)
    center = np.stack([radius * np.sin(t), radius * (1 - np.cos(t))], axis=1)
    return prepare_reference_path(center, extension=30.0, dtype=dtype)


def ref_to_torch(ref_np, dtype=torch.float64):
    return type(ref_np)(*(torch.as_tensor(np.array(f), dtype=dtype) for f in ref_np))


def torch_rollout(jro):
    """The port's Rollout carrying a JAX rollout's values (float64, CPU)."""
    from frenetix_tpu_torch.ops.kinematics import Rollout

    fields = {}
    for f in jro._fields:
        v = getattr(jro, f)
        if f == "extras":
            fields[f] = tuple(t64(x) for x in v) if v is not None else None
        elif f == "traj_len":
            fields[f] = torch.as_tensor(np.array(v))
        else:
            fields[f] = t64(v)
    return Rollout(**fields)


def reach_grid_to_torch(jgrid, device=CPU, dtype=torch.float64):
    """The port's ReachSetGrid carrying a JAX ReachSetGrid's values."""
    from frenetix_tpu_torch.risk.reachable_set import reach_grid_from_numpy

    return reach_grid_from_numpy(
        to_np(jgrid.origin), to_np(jgrid.occupancy), to_np(jgrid.valid),
        to_np(jgrid.cell), jgrid.dt_rs, device=device, dtype=dtype)


def lanelet_tensors_to_torch(jlane, device=CPU, dtype=torch.float64):
    """The port's LaneletTensors carrying a JAX LaneletTensors' values."""
    from frenetix_tpu_torch.risk.reachable_set import lanelet_tensors_from_numpy

    return lanelet_tensors_from_numpy(
        to_np(jlane.rings), to_np(jlane.ring_valid), to_np(jlane.closure),
        device=device, dtype=dtype)


def random_risks(rng, m, o, lead=()):
    """(JAX TrajectoryRisks, the port's) with the same random values; `lead`
    are leading agent axes of the port's copy (the JAX one is built without
    them when `lead` is empty, else not at all: None)."""
    import jax.numpy as jnp
    from frenetix_tpu.risk.costs import TrajectoryRisks as JRisks
    from frenetix_tpu_torch.risk.costs import TrajectoryRisks as TRisks

    shape = tuple(lead) + (m, o)
    per = {k: rng.uniform(0.0, 1.0, shape) for k in (
        "ego_risk_per_obst", "obst_risk_per_obst", "ego_harm_per_obst",
        "obst_harm_per_obst", "coll_prob_per_obst")}
    # some exactly-zero risks, so that the maximin mask has both sides
    per["ego_risk_per_obst"][..., ::2, :] = 0.0
    present = rng.uniform(size=tuple(lead) + (o,)) < 0.7
    fields = dict(per, ego_risk=per["ego_risk_per_obst"].max(-1, initial=0.0),
                  obst_risk=per["obst_risk_per_obst"].max(-1, initial=0.0),
                  obst_present=present)
    jr = None if lead else JRisks(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jr, TRisks(**{k: t64(v) for k, v in fields.items()})


class Arrays:
    """A stand-in for a rollout or predictions: the given arrays as
    attributes, each passed through `xp` (`jnp_array` or `t64`)."""

    def __init__(self, xp, **arrays):
        for k, v in arrays.items():
            setattr(self, k, xp(v))


def jnp_array(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def agent_states(sim):
    """Per agent the executed (x, y, v) rows of a simulation of either package."""
    return {a.id: np.array([[*s.position, s.velocity] for s in a.record.states])
            for a in sim.agents}


def coarse_sampling(cfg):
    """Sampling level 1 only (a few dozen candidates per cycle): the risk
    stack on one CPU thread is slow."""
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    return cfg


# ------------------------------------------------- post-passes in the device run


def blind_spot(factory, commonroad, truck_x=60.0, n_steps=150):
    """The highway with a parked truck beside the lane at `truck_x`: a blind
    spot for the occlusion module and the visible-area stage."""
    sc = factory.make_highway(ego_v=13.0, lead_v=13.0, lead_gap=120.0, n_steps=n_steps)
    sc.obstacles[200] = commonroad.Obstacle(
        obstacle_id=200, obstacle_type="truck", role="static", length=9.0, width=2.5,
        initial_state=commonroad.State(0, np.array([truck_x, 2.6]), 0.0, 0.0))
    return sc


def post_pass_config(make, *, resp=0.0, module=False, soft=True, vis=False,
                     max_obstacles=4, multi=True):
    """A float64 config at level-1 sampling with the requested post-passes:
    the responsibility weight `resp`, the occlusion module (harm threshold
    0.02, with `soft` the occ_um 2.0 / occ_ve 0.5 terms), the visible-area
    stage `vis`."""
    cfg = coarse_sampling(make(dtype="float64"))
    cfg.simulation.start_multiagent = multi
    cfg.prediction.max_obstacles = max_obstacles
    cfg.cost_weights["responsibility"] = resp
    cfg.prediction.calc_occlusions = vis
    if module:
        cfg.occlusion.use_occlusion_module = True
        cfg.occlusion.harm_threshold = 0.02
        if soft:
            cfg.external_cost_weights["occ_um"] = 2.0
            cfg.external_cost_weights["occ_ve"] = 0.5
    return cfg


def c_struct_fields(source, struct="Args"):
    """(name, kind) of every member of `struct` in a kernel source file, in
    order; kind is "ptr", "i64" or "f64" (the members a ctypes argument
    block mirrors)."""
    import re
    from pathlib import Path

    body = Path(source).read_text().split(f"struct {struct} {{", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind = "f64" if decl.startswith("double") else (
            "i64" if decl.startswith("int64_t") else "ptr")
        names = re.sub(r"^(const\s+)?(void|int64_t|double)\s*\*?", "", decl)
        for name in names.split(","):
            name = name.strip()
            fields.append((name.lstrip("*").strip(),
                           "ptr" if name.startswith("*") or kind == "ptr" else kind))
    return fields


def ctypes_fields(structure):
    """(name, kind) of a ctypes.Structure's fields, kinds as `c_struct_fields`."""
    kinds = {"c_void_p": "ptr", "c_long": "i64", "c_longlong": "i64", "c_double": "f64"}
    return [(name, kinds[t.__name__]) for name, t in structure._fields_]


def host_count(name: str) -> int:
    """The port's host counter `name` (`utils.tracing`), 0 before its first
    count: kernel launches (`kernel.k1.launches`, ...) and device→host
    copies (`device_sim.fetches`)."""
    from frenetix_tpu_torch.utils import tracing

    return tracing.COUNTERS.get(name, 0)


def device_and_host(make, cfg, steps):
    """(DeviceSimulation, its result, the host sequential Simulation, its
    result) of the port, both cut to `steps` steps; the run fetches once."""
    from frenetix_tpu_torch.parallel import device_sim as tds
    from frenetix_tpu_torch.sim.simulation import Simulation

    sim = Simulation(make(), cfg, CPU)
    sim.max_steps = steps
    ds = tds.DeviceSimulation(sim)
    fetches = host_count("device_sim.fetches")
    dres = ds.run()
    assert host_count("device_sim.fetches") == fetches + 1, "one fetch per run"
    host = Simulation(make(), cfg, CPU)
    host.max_steps = steps
    return ds, dres, host, host.run()


def assert_run_equals_host(dres, hres, atol=1e-9):
    """A device run against a host run: statuses and steps equal, executed
    positions and velocities within `atol`."""
    assert dres.steps == hres.steps
    assert [int(s) for s in dres.status] == [int(hres.agent_status[a])
                                            for a in dres.agent_ids]
    for col, aid in enumerate(dres.agent_ids):
        hist = hres.histories[aid]
        pos = np.array([s.position for s in hist[1:]])
        vel = np.array([s.velocity for s in hist[1:]])
        assert len(pos) > 0
        np.testing.assert_allclose(dres.trajectories[:len(pos), col, :2], pos,
                                   rtol=0, atol=atol, err_msg=f"agent {aid}")
        np.testing.assert_allclose(dres.trajectories[:len(vel), col, 3], vel,
                                   rtol=0, atol=atol, err_msg=f"agent {aid}")


def assert_equal_runs(a, b, what, atol=1e-9):
    """Two device runs: statuses and steps equal, trajectories within atol."""
    assert [int(s) for s in a.status] == [int(s) for s in b.status], what
    assert a.steps == b.steps, what
    np.testing.assert_allclose(a.trajectories[:a.steps], b.trajectories[:b.steps],
                               rtol=0, atol=atol, err_msg=what)


# ------------------------------------------------- whole runs of both packages


def behavior_recorder(sim):
    """The time steps at which the first agent's behavior module rebuilt the
    reference path (a list filled while `sim` runs)."""
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


def paired_runs(family, dtype, *, behavior=False, multiagent=False, trace=False):
    """The JAX package's and the port's run of the default-size `family`
    (`make_<family>()`) at `dtype` on the CPU.  Returns one dict per package
    with the result, the executed (x, y, v) rows per agent, the reference-path
    rebuild steps (with `behavior`) and, with `trace`, the run's
    `utils.parting.CycleTrace`.  With `multiagent` every obstacle is an agent
    and the agents' cycles run batched."""
    from frenetix_tpu.behavior import behavior_module as jbehavior
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.planner import reactive as jreactive
    from frenetix_tpu.sim.simulation import Simulation as JSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig
    from frenetix_tpu_torch.behavior import behavior_module as tbehavior
    from frenetix_tpu_torch.io import scenario_factory as tfactory
    from frenetix_tpu_torch.planner import reactive as treactive
    from frenetix_tpu_torch.sim.simulation import Simulation as TSimulation
    from frenetix_tpu_torch.utils.config import FrenetixConfig as TConfig
    from frenetix_tpu_torch.utils.parting import CycleTrace

    def config(cls):
        cfg = cls(dtype=dtype)
        cfg.behavior.use_behavior_planner = behavior
        cfg.simulation.start_multiagent = multiagent
        cfg.simulation.batched_device_agents = multiagent
        return cfg

    runs = {}
    for side, sim, reactive, bmod in (
            ("jax", lambda: JSimulation(getattr(jfactory, f"make_{family}")(),
                                        config(JConfig)), jreactive, jbehavior),
            ("port", lambda: TSimulation(getattr(tfactory, f"make_{family}")(),
                                         config(TConfig), CPU), treactive, tbehavior)):
        s = sim()
        with CycleTrace(reactive, bmod) if trace else contextlib.nullcontext() as tr:
            swaps = behavior_recorder(s) if behavior else None
            res = s.run()
        runs[side] = {"result": res, "states": agent_states(s), "swaps": swaps,
                      "trace": tr}
    return runs["jax"], runs["port"]


def statuses(res):
    return {int(k): int(v) for k, v in res.agent_status.items()}


def assert_classified_parting(jax_run, port_run, *, plan, replanning_frequency=3,
                              pos_tol=1e-4, dt=0.1, n_steps=30):
    """The two float32 behavior runs select alike up to the cycle of the
    `plan`-th plan call and part there by a float32 threshold flip
    (`utils.parting`): positions within `pos_tol` up to that cycle's step,
    the FSM's outputs equal there, and the flipped test's margin asserted.
    Returns the Parting."""
    from frenetix_tpu_torch.utils.parting import classify_parting, first_parting

    jt, tt = jax_run["trace"], port_run["trace"]
    level = first_parting(jt, tt)
    assert level is not None, "the float32 runs never part"
    parting = classify_parting(jt, tt, level, dt=dt, n_steps=n_steps)
    assert parting.plan == plan, parting
    assert parting.kind == "threshold", parting.detail
    step = replanning_frequency * plan
    for aid, want in jax_run["states"].items():
        np.testing.assert_allclose(port_run["states"][aid][:step + 1, :2],
                                   want[:step + 1, :2], rtol=0, atol=pos_tol)
    assert jt.plans[plan]["fsm_state"] == tt.plans[plan]["fsm_state"] is not None
    for cand, m in parting.margins.items():
        # the stopping candidate's exact end velocity is 0 ...
        assert abs(m["s_vel_f64"]) <= 1e-9, (cand, m)
        # ... and float32 rounding put it beyond the -1e-5 test on one side
        assert m["s_vel_f32"] < -1e-5, (cand, m)
        assert m["rounding_units"] <= 32, (cand, m)
    return parting
