"""The pieces of the post-passes in the port's device-resident run, against
the JAX package at float64 on the CPU (same numpy inputs on both sides):

- the new `SimTensors` leaves (lanelets, road walls, raw window sizes, the
  occlusion spawn tensors) of a constructed, never-run JAX
  `DeviceSimulation` with every post-pass on;
- `_occlusion_spawn_tensors` on the blind spot and on a left turn (turn
  spawn points on);
- the phantom locator `phantom_rows` against the JAX `_phantom_fn`, jitted
  alone, at random ego positions and free-slot counts: admitted rows, spawn
  points and every prediction field within 1e-12;
- the slot trim: which window slots the run keeps, and that a fleet keeps
  the union of its members'.

No JAX run is made: its post-pass programs compile for minutes.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import commonroad as tcr, scenario_factory as tfactory
from frenetix_tpu_torch.occlusion.occlusion_module import PHANTOM_TYPES
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import FrenetixConfig

from torch_parity import CPU, coarse_sampling, to_np

torch.set_num_threads(1)

TOL = 1e-12


def _blind_spot(factory, commonroad):
    """A parked truck beside the lane creates a blind spot."""
    sc = factory.make_highway(ego_v=13.0, lead_v=13.0, lead_gap=120.0, n_steps=150)
    sc.obstacles[200] = commonroad.Obstacle(
        obstacle_id=200, obstacle_type="truck", role="static", length=9.0, width=2.5,
        initial_state=commonroad.State(0, np.array([60.0, 2.6]), 0.0, 0.0))
    return sc


def _scenario(case, factory, commonroad):
    if case == "blind_spot":
        return _blind_spot(factory, commonroad)
    return factory.make_turn_left(n_steps=120)


def _cfg(make, case):
    cfg = coarse_sampling(make(dtype="float64"))
    cfg.occlusion.use_occlusion_module = True
    cfg.occlusion.spawn_points_behind_turn = case == "turn_left"
    cfg.occlusion.max_dynamic_spawn_points = 1
    cfg.external_cost_weights["occ_um"] = 2.0
    cfg.prediction.calc_occlusions = True
    cfg.prediction.max_obstacles = 4
    cfg.cost_weights["responsibility"] = 0.2
    cfg.simulation.start_multiagent = True
    return cfg


@pytest.fixture(scope="module", params=["blind_spot", "turn_left"])
def both(request):
    """The same scenario as a device-resident simulation of both packages,
    with the responsibility term, the sensor stage and the occlusion module
    (constructed, not run)."""
    from frenetix_tpu.io import commonroad as jcr, scenario_factory as jfactory
    from frenetix_tpu.parallel.device_sim import DeviceSimulation as JDeviceSim
    from frenetix_tpu.sim import Simulation as JSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    case = request.param
    jsim = JSimulation(_scenario(case, jfactory, jcr), _cfg(JConfig, case))
    tsim = Simulation(_scenario(case, tfactory, tcr), _cfg(FrenetixConfig, case), CPU)
    for s in (jsim, tsim):
        s.max_steps = 60
    return case, JDeviceSim(jsim), tds.DeviceSimulation(tsim)


def test_new_host_tensors_match_jax(both):
    """Every SimTensors leaf of the post-passes equals the JAX package's."""
    _, jds, tsim = both
    jg, tg = jds.tensors, tsim.tensors
    names = ("road_segs", "cur_half", "occ_obst", "occ_obst_valid", "occ_is_dyn",
             "occ_half", "occ_cat_ok", "turn_xy", "turn_spawn", "turn_heading",
             "turn_hot")
    pairs = [(n, getattr(jg, n), getattr(tg, n)) for n in names]
    pairs += [(f"lane.{f}", getattr(jg.lane, f), getattr(tg.lane, f))
              for f in tg.lane._fields]
    for name, a, b in pairs:
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert a.dtype == bool or b.dtype != bool, name
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=0, atol=TOL, err_msg=name)


def test_occlusion_spawn_tensors_match_jax(both):
    """The module-level builders of both packages on the same host
    simulation's agents; the left turn has hot route vertices."""
    from frenetix_tpu.parallel.device_sim import _occlusion_spawn_tensors as jspawn

    case, jds, tsim = both
    want = jspawn(jds.sim, jds.agents, jds.n_cycles, jds.k_replan, np.float64)
    got = tds._occlusion_spawn_tensors(tsim.sim, tsim.agents, tsim.n_cycles,
                                       tsim.k_replan, np.float64)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=0, atol=TOL,
                                   err_msg=k)
    assert got["turn_hot"].any() == (case == "turn_left")


def _port_phantoms(tsim, c, ego, n_free, horizon):
    g = tsim.tensors
    occ = tsim.config.occlusion
    ph_type = PHANTOM_TYPES[occ.phantom_type]
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    return tds.phantom_rows(
        t(ego), t(n_free), t(g.occ_obst[c]), t(g.occ_obst_valid[c]), t(g.occ_is_dyn),
        t(g.occ_half), t(g.occ_cat_ok), t(g.turn_xy), t(g.turn_spawn),
        t(g.turn_heading), t(g.turn_hot), horizon=horizon, dt=tsim.dt,
        sensor_radius=float(tsim.config.prediction.sensor_radius),
        max_phantoms=int(occ.max_phantoms),
        max_dynamic=int(occ.max_dynamic_spawn_points),
        max_static=int(occ.max_static_spawn_points),
        use_turn=bool(occ.spawn_points_behind_turn), velocity=ph_type["velocity"],
        var_factor=float(occ.variance_factor),
        length=ph_type["length"] * float(occ.size_factor_length),
        width=ph_type["width"] * float(occ.size_factor_width))


@pytest.mark.parametrize("seed", [0, 1])
def test_phantom_locator_matches_jax(both, seed):
    """`phantom_rows` for all agents at once against the JAX `_phantom_fn`
    per agent, at egos scattered over the scenario (some beside the
    obstacles, some out of sensor range) and free-slot counts from none to
    more than max_phantoms."""
    import jax
    import jax.numpy as jnp

    case, jds, tsim = both
    rng = np.random.default_rng(seed)
    horizon = int(tsim.tensors.pred_windows["means"].shape[2])
    jfn = jax.jit(jds._phantom_fn(horizon))
    jg = jds.tensors
    a_n = len(tsim.agents)
    admitted_any = 0
    for _ in range(6):
        c = int(rng.integers(0, tsim.n_cycles))
        ego = tsim.pose0[:, :2] + rng.uniform(-40.0, 80.0, (a_n, 2)) * [1.0, 0.2]
        n_free = rng.integers(-1, 6, a_n)
        ph, ok, pos = _port_phantoms(tsim, c, ego, n_free, horizon)
        for i in range(a_n):
            jph, jok, jpos = jfn(jg, c, jnp.asarray(ego[i]), jnp.asarray(n_free[i]),
                                 jg.turn_xy[i], jg.turn_spawn[i], jg.turn_heading[i],
                                 jg.turn_hot[i])
            np.testing.assert_array_equal(ok[i].numpy(), to_np(jok))
            admitted_any += int(to_np(jok).sum())
            sel = to_np(jok)
            np.testing.assert_allclose(pos[i].numpy()[sel], to_np(jpos)[sel],
                                       rtol=0, atol=TOL)
            for f in ph._fields:
                a, b = to_np(getattr(jph, f)), getattr(ph, f)[i].numpy()
                assert a.shape == b.shape, f
                if f in ("means", "orientations"):
                    a, b = a[sel], b[sel]       # rows that are not admitted
                np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                           rtol=0, atol=TOL, err_msg=f)
    assert admitted_any > 0


def test_window_slots_kept_for_the_run(both):
    """The run's buffers keep the window slots valid at some cycle, in
    order; `tensors` keeps the full width (the JAX package's)."""
    case, jds, tsim = both
    valid = np.asarray(tsim.tensors.pred_windows["valid"])          # (C, O, H)
    keep = tds._kept_slots(tsim.tensors)
    used = np.flatnonzero(valid.any(axis=(0, 2)))
    # the left turn's one other vehicle is an agent: no slot is filled, and
    # the run keeps one
    np.testing.assert_array_equal(keep, used if case == "blind_spot" else [0])
    assert len(used) == (1 if case == "blind_spot" else 0)
    assert valid.shape == to_np(jds.tensors.pred_windows["valid"]).shape
    trimmed = tds._trim_slots(tsim.tensors, keep)
    assert trimmed.pred_windows["means"].shape[1] == len(keep)
    assert trimmed.cur_half.shape[1] == trimmed.cur_obst.shape[1] == len(keep)
    # the occluders and the spawn tensors stay whole
    assert trimmed.obst_half.shape == tsim.tensors.obst_half.shape
    assert trimmed.occ_obst.shape == tsim.tensors.occ_obst.shape


def test_kept_slots_of_a_fleet_are_the_union():
    def windows(valid_slots):
        v = np.zeros((3, 5, 4), bool)
        for c, o in valid_slots:
            v[c, o, :2] = True
        return type("G", (), {"pred_windows": {"valid": v}})()

    a, b = windows([(0, 1), (2, 3)]), windows([(1, 1), (1, 4)])
    np.testing.assert_array_equal(tds._kept_slots(a), [1, 3])
    np.testing.assert_array_equal(tds._kept_slots(a, b), [1, 3, 4])
    # no slot is valid anywhere: one is kept all the same
    np.testing.assert_array_equal(tds._kept_slots(windows([])), [0])


def test_padded_lanelets_rasterize_each_member_on_its_own_map():
    """A fleet's reach grids (`reach_grids` over the scenario axis, on the
    lanelets padded by `_padded_tensors`) equal each member's grids on its
    own unpadded map: padding lanelets and vertices are inert."""
    from collections import namedtuple

    from frenetix_tpu_torch.risk.reachable_set import (
        LaneletTensors, build_reach_set_grids_device, lanelet_tensors)

    sims = []
    for case in ("blind_spot", "turn_left"):
        cfg = coarse_sampling(FrenetixConfig(dtype="float64"))
        cfg.cost_weights["responsibility"] = 0.2
        cfg.simulation.start_multiagent = True
        sims.append(tds.DeviceSimulation(
            Simulation(_scenario(case, tfactory, tcr), cfg, CPU)))
    stacked = tds._fleet_stack(sims, tds._fleet_dims(sims))
    assert sims[0].tensors.lane.rings.shape != sims[1].tensors.lane.rings.shape
    lane = LaneletTensors(*(torch.as_tensor(x) for x in stacked.lane))

    rng = np.random.default_rng(3)
    s_n, a_n, o_n = 2, stacked.x_cl0.shape[1], 2
    centers = stacked.pose0[:, :, None, :2] + rng.normal(0.0, 3.0, (s_n, a_n, o_n, 2))
    Preds = namedtuple("Preds", "means orientations velocities lengths widths valid")
    preds = Preds(
        means=torch.as_tensor(centers[..., None, :]),
        orientations=torch.as_tensor(rng.uniform(-np.pi, np.pi, (s_n, a_n, o_n, 1))),
        velocities=torch.as_tensor(rng.uniform(0.0, 15.0, (s_n, a_n, o_n, 1))),
        lengths=torch.as_tensor(rng.uniform(3.0, 6.0, (s_n, a_n, o_n))),
        widths=torch.as_tensor(rng.uniform(1.5, 2.5, (s_n, a_n, o_n))),
        valid=torch.as_tensor(rng.random((s_n, a_n, o_n, 1)) < 0.8))
    grid = tds.reach_grids(preds, lane, 1)
    assert grid.occupancy.shape[:3] == (s_n, a_n, o_n)
    for s, sim in enumerate(sims):
        own = lanelet_tensors(sim.sim.scenario, device=CPU, dtype=torch.float64)
        want = build_reach_set_grids_device(
            preds.means[s, ..., 0, :].reshape(-1, 2),
            preds.orientations[s, ..., 0].reshape(-1),
            preds.velocities[s, ..., 0].reshape(-1), preds.lengths[s].reshape(-1),
            preds.widths[s].reshape(-1), preds.valid[s, ..., 0].reshape(-1), own)
        assert want.occupancy.any()
        np.testing.assert_array_equal(
            grid.occupancy[s].reshape(want.occupancy.shape).numpy(),
            want.occupancy.numpy())
        np.testing.assert_array_equal(grid.cell[s].reshape(-1).numpy(), want.cell.numpy())
