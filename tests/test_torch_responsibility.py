"""The port's responsibility stack against the JAX package, float64 on the CPU.

- The ethical aggregations of `risk/costs.py` and every function of
  `risk/reachable_set.py` on the same NumPy inputs: masks, grids and indices
  equal, float tensors within rtol 1e-10.
- `build_reach_set_grids` against the JAX package's on the intersection, lane
  merge and highway families (occupancy, cell sizes and validity equal).  The
  JAX package tests lanelet membership through its compiled helper where that
  library is built, else through NumPy; the port always scans in NumPy.  The
  test prints which route the JAX side took.
- The device rasterizer equal to the host one at float64.
- The gather with a leading agent axis equal to the per-agent gather, and the
  half-to-even rounding of the reach-set step index.
- One `ReactivePlanner.plan` cycle with responsibility 0.2 selects the JAX
  planner's candidate at its cost.
- `batched_full_cycle(resp_weight=...)` against the JAX one on the stacked
  problem (A = 4) with a grid that bites.
- Multi-agent `Simulation` with responsibility 0.2: sequential against JAX,
  batched against sequential, positions within 1e-9 m.

Where the JAX functions would reach the Pallas kernel on a TPU they run its
plain route here, as the JAX package's own tests do on the CPU.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.parallel import mesh as tmesh
from frenetix_tpu_torch.planner.core import context_from_numpy, evaluate_cycle as teval
from frenetix_tpu_torch.risk import costs as tcosts
from frenetix_tpu_torch.risk import reachable_set as trs
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.sim.prediction import to_device
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig
from tests.torch_parity import (
    CPU, Arrays, agent_states, coarse_sampling, jnp_array, lanelet_tensors_to_torch,
    random_risks, reach_grid_to_torch, t64, to_np,
)

torch.set_num_threads(1)

RTOL = 1e-10
FAMILIES = ["intersection_crossing", "lane_merge", "highway"]


# ------------------------------------------------------ ethical aggregations


@pytest.mark.parametrize("m,o", [(5, 3), (64, 16), (7, 1)])
@pytest.mark.parametrize("name", ["bayesian_costs", "equality_costs",
                                  "maximin_costs", "ego_costs"])
def test_ethical_costs_match_jax(name, m, o):
    from frenetix_tpu.risk import costs as jcosts

    rng = np.random.default_rng(m * 31 + o)
    jr, tr = random_risks(rng, m, o)
    bh = rng.uniform(0.0, 0.5, m)
    args_j = (jr,) if name == "equality_costs" else (jr, jnp_array(bh))
    args_t = (tr,) if name == "equality_costs" else (tr, t64(bh))
    want = np.asarray(getattr(jcosts, name)(*args_j))
    got = getattr(tcosts, name)(*args_t)
    assert got.dtype == torch.float64 and got.shape == (m,)
    np.testing.assert_allclose(to_np(got), want, rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("m,o", [(5, 3), (64, 16)])
def test_responsibility_costs_match_jax(m, o):
    from frenetix_tpu.ops.costs import PredictionTensors as JPreds
    from frenetix_tpu.risk.costs import responsibility_costs as jfn
    from frenetix_tpu_torch.ops.costs import PredictionTensors as TPreds

    rng = np.random.default_rng(o)
    jr, tr = random_risks(rng, m, o)
    means = rng.normal(size=(o, 6, 2)) * 20.0
    blank = {k: np.zeros(1) for k in JPreds._fields if k != "means"}
    pos, th = np.array([1.0, -2.0]), 0.4
    want = np.asarray(jfn(jr, JPreds(means=jnp_array(means), **blank),
                          jnp_array(pos), th))
    got = tcosts.responsibility_costs(
        tr, TPreds(means=t64(means), **{k: t64(v) for k, v in blank.items()}), pos, th)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(to_np(got), want, rtol=RTOL, atol=1e-300)
    assert float(np.abs(want).max()) > 0.0


def test_ethical_costs_with_agent_axis_equal_per_agent():
    rng = np.random.default_rng(4)
    _, tr = random_risks(rng, 9, 5, lead=(3,))
    bh = t64(rng.uniform(0.0, 0.5, (3, 9)))
    for name in ("bayesian_costs", "maximin_costs", "ego_costs"):
        got = getattr(tcosts, name)(tr, bh)
        for a in range(3):
            one = getattr(tcosts, name)(type(tr)(*(f[a] for f in tr)), bh[a])
            if name == "maximin_costs":
                # x ** 10 on the CPU rounds the last bit differently in the
                # vectorized body and in the tail of a row
                np.testing.assert_allclose(to_np(got[a]), to_np(one), rtol=4e-16)
            else:
                np.testing.assert_array_equal(to_np(got[a]), to_np(one), err_msg=name)


# --------------------------------------------------------- hexagon, closure


@pytest.mark.parametrize("v0", [0.0, 3.0, 13.9, 30.0])
def test_spot_hexagon_params_match_jax(v0):
    from frenetix_tpu.risk.reachable_set import spot_hexagon_params as jfn

    for got, want in zip(trs.spot_hexagon_params(v0, 0.2, 2.0, 8.0),
                         jfn(v0, 0.2, 2.0, 8.0)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("j", [0, 1, 5, 10])
def test_hexagon_contains_matches_jax(j):
    from frenetix_tpu.risk.reachable_set import hexagon_contains as jfn

    rng = np.random.default_rng(j)
    pts = rng.uniform(-10.0, 45.0, size=(4000, 2)) * np.array([1.0, 0.4])
    params = trs.spot_hexagon_params(12.0, 0.2, 2.0, 8.0)
    got = trs.hexagon_contains(pts, j, params, 4.5, 1.8)
    np.testing.assert_array_equal(got, jfn(pts, j, params, 4.5, 1.8))
    assert 0 < got.sum() < len(pts)


@pytest.mark.parametrize("family", FAMILIES)
def test_reachable_lanelet_ids_match_jax(family):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.risk.reachable_set import reachable_lanelet_ids as jfn

    jsc = getattr(jfactory, f"make_{family}")()
    tsc = getattr(tfactory, f"make_{family}")()
    for depth in (0, 1, 3):
        for lid in tsc.lanelets:
            assert trs.reachable_lanelet_ids(tsc, [lid], depth) == jfn(jsc, [lid], depth)


def test_point_in_lanelet_reach_set_matches_jax():
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.risk.reachable_set import point_in_lanelet_reach_set as jfn

    jsc, tsc = jfactory.make_lane_merge(), tfactory.make_lane_merge()
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5.0, 80.0, size=(3000, 2)) * np.array([1.0, 0.15])
    kw = dict(position=np.array([20.0, 0.3]), orientation=0.05, velocity=11.0,
              length=4.5, width=1.8)
    for j in (0, 4, 10):
        got = trs.point_in_lanelet_reach_set(
            pts, j, lanelet_rings=[ll.polygon for ll in tsc.lanelets.values()], **kw)
        want = jfn(pts, j, lanelet_rings=[ll.polygon for ll in jsc.lanelets.values()],
                   **kw)
        np.testing.assert_array_equal(got, want)
    assert got.any()


# ------------------------------------------------------------------- grids


def _grid_inputs(scenario):
    """The scenario's dynamic obstacles at step 0 (where it has some), the
    ego's start pose, a fast obstacle off the lanelet network and one invalid
    row."""
    obs = [ob for ob in scenario.dynamic_obstacles if ob.state_at_time(0) is not None]
    pos = [np.asarray(ob.state_at_time(0).position, float) for ob in obs]
    th = [float(ob.state_at_time(0).orientation) for ob in obs]
    v = [float(ob.state_at_time(0).velocity) for ob in obs]
    ln = [ob.length for ob in obs]
    wd = [ob.width for ob in obs]
    ego = next(iter(scenario.planning_problems.values())).initial_state
    ego_pos = np.asarray(ego.position, float)
    pos += [ego_pos, np.array([900.0, 900.0]), ego_pos + 1.0]
    th += [float(ego.orientation), 0.3, float(ego.orientation)]
    v += [float(ego.velocity), 25.0, 4.0]
    ln += [4.5, 4.5, 4.5]
    wd += [1.8, 1.8, 1.8]
    valid = np.ones(len(pos), bool)
    valid[-1] = False
    return (np.array(pos), np.array(th), np.array(v), np.array(ln), np.array(wd),
            valid)


@pytest.mark.parametrize("family", FAMILIES)
def test_build_reach_set_grids_match_jax(family, capsys):
    from frenetix_tpu import native
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.risk.reachable_set import build_reach_set_grids as jbuild

    jsc = getattr(jfactory, f"make_{family}")()
    tsc = getattr(tfactory, f"make_{family}")()
    args = _grid_inputs(tsc)
    with capsys.disabled():
        print(f"\n[{family}] the JAX package's lanelet test ran through "
              f"{'the compiled helper' if native.available() else 'NumPy'}")
    want = jbuild(jsc, *args)
    got = trs.build_reach_set_grids(tsc, *args, device=CPU)
    assert got.occupancy.dtype == torch.bool and got.origin.dtype == torch.float64
    np.testing.assert_array_equal(to_np(got.occupancy), np.asarray(want.occupancy))
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(to_np(got.cell), np.asarray(want.cell))
    np.testing.assert_array_equal(to_np(got.origin), np.asarray(want.origin))
    assert got.dt_rs == want.dt_rs
    occ = to_np(got.occupancy)
    assert occ[:-1].any(axis=(1, 2, 3)).all() and not occ[-1].any()
    # the fast obstacle's cells grew so that the grid covers its reach
    assert float(got.cell[-2]) > 1.5


@pytest.mark.parametrize("family", FAMILIES)
def test_device_grid_rasterizer_equals_the_host_one(family):
    tsc = getattr(tfactory, f"make_{family}")()
    pos, th, v, ln, wd, valid = _grid_inputs(tsc)
    host = trs.build_reach_set_grids(tsc, pos, th, v, ln, wd, valid, device=CPU)
    lane = trs.lanelet_tensors(tsc, device=CPU)
    dev = trs.build_reach_set_grids_device(
        t64(pos), t64(th), t64(v), t64(ln), t64(wd), torch.as_tensor(valid), lane)
    np.testing.assert_array_equal(to_np(dev.occupancy), to_np(host.occupancy))
    np.testing.assert_array_equal(to_np(dev.cell), to_np(host.cell))
    np.testing.assert_array_equal(to_np(dev.valid), to_np(host.valid))
    assert dev.dt_rs == host.dt_rs


def test_device_grid_rasterizer_chunks_change_nothing(monkeypatch):
    tsc = tfactory.make_intersection_crossing()
    pos, th, v, ln, wd, valid = _grid_inputs(tsc)
    lane = trs.lanelet_tensors(tsc, device=CPU)
    args = (t64(pos), t64(th), t64(v), t64(ln), t64(wd), torch.as_tensor(valid), lane)
    whole = trs.build_reach_set_grids_device(*args)
    monkeypatch.setattr(trs, "_MAX_CROSSING_ELEMENTS", 1)    # one obstacle a chunk
    chunked = trs.build_reach_set_grids_device(*args)
    assert torch.equal(whole.occupancy, chunked.occupancy)
    assert torch.equal(whole.cell, chunked.cell)


@pytest.mark.parametrize("family", FAMILIES)
def test_lanelet_tensors_match_jax(family):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.risk.reachable_set import lanelet_tensors as jfn

    want = jfn(getattr(jfactory, f"make_{family}")())
    got = trs.lanelet_tensors(getattr(tfactory, f"make_{family}")(), device=CPU)
    for name in want._fields:
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    carried = lanelet_tensors_to_torch(want)
    assert all(torch.equal(a, b) for a, b in zip(carried, got))


def _random_grid(rng, o, t_rs=11, g=16, fill=0.5):
    from frenetix_tpu.risk.reachable_set import ReachSetGrid as JGrid

    return JGrid(
        origin=jnp_array(rng.normal(size=(o, 2)) * 4.0),
        occupancy=jnp_array(rng.uniform(size=(o, t_rs, g, g)) < fill),
        valid=jnp_array(np.arange(o) % 4 != 3),
        cell=jnp_array(rng.uniform(1.0, 2.5, o)),
        dt_rs=0.2,
    )


@pytest.mark.parametrize("lead,o,n", [((), 3, 5), ((7,), 4, 30), ((6, 2), 16, 9)])
def test_points_in_reach_grids_match_jax(lead, o, n):
    from frenetix_tpu.risk.reachable_set import points_in_reach_grids as jfn

    rng = np.random.default_rng(o + n)
    jgrid = _random_grid(rng, o)
    # many points on the grid, some off it, some exactly on cell borders
    pts = rng.uniform(-22.0, 22.0, size=lead + (n, 2))
    pts.reshape(-1, 2)[::7] = np.round(pts.reshape(-1, 2)[::7])
    steps = rng.integers(-1, 14, n)          # also outside [0, T): clipped
    want = np.asarray(jfn(jnp_array(pts), jnp_array(steps), jgrid))
    got = trs.points_in_reach_grids(t64(pts), torch.as_tensor(steps),
                                    reach_grid_to_torch(jgrid))
    assert got.dtype == torch.bool and got.shape == lead + (o, n)
    np.testing.assert_array_equal(to_np(got), want)
    assert 0 < want.sum() < want.size


def test_reach_grid_gather_with_agent_axis_equals_per_agent():
    rng = np.random.default_rng(12)
    grids = [reach_grid_to_torch(_random_grid(rng, 5)) for _ in range(3)]
    stacked = tmesh.stack_reach_grids(grids)
    assert stacked.occupancy.shape == (3, 5, 11, 16, 16) and stacked.dt_rs == 0.2
    pts = t64(rng.uniform(-20.0, 20.0, size=(3, 8, 30, 2)))
    steps = torch.as_tensor(rng.integers(0, 11, 30))
    got = trs.points_in_reach_grids(pts, steps, stacked)
    assert got.shape == (3, 8, 5, 30)
    for a in range(3):
        assert torch.equal(got[a], trs.points_in_reach_grids(pts[a], steps, grids[a]))


def test_stack_reach_grids_matches_jax():
    from frenetix_tpu.parallel.mesh import stack_reach_grids as jstack

    rng = np.random.default_rng(13)
    jgrids = [_random_grid(rng, 4) for _ in range(3)]
    want = jstack(jgrids)
    got = tmesh.stack_reach_grids([reach_grid_to_torch(g) for g in jgrids])
    for name in ("origin", "occupancy", "valid", "cell"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def test_step_index_rounds_half_to_even():
    """dt = 0.1 against dt_rs = 0.2: every odd planner step is a tie."""
    k = torch.arange(1, 31, dtype=torch.float64)
    got = torch.round(k * 0.1 / 0.2).long().numpy()
    want = np.round(np.arange(1, 31) * 0.1 / 0.2).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert torch.round(torch.tensor([0.5, 1.5, 2.5, 3.5],
                                    dtype=torch.float64)).tolist() == [0.0, 2.0, 2.0, 4.0]
    assert got[0] == 0 and got[4] == 2      # k = 1 → 0.5 → 0, k = 5 → 2.5 → 2


def _rollout_pair(rng, m, n1):
    x = np.cumsum(rng.uniform(0.2, 1.5, (m, n1)), axis=1) - 10.0
    y = rng.normal(size=(m, n1)) * 3.0
    return (Arrays(jnp_array, x=x, y=y), Arrays(t64, x=x, y=y))


@pytest.mark.parametrize("m,o,n1", [(6, 3, 11), (64, 16, 31), (9, 0, 31)])
def test_responsibility_reach_grid_matches_jax(m, o, n1):
    from frenetix_tpu.risk.reachable_set import responsibility_reach_grid as jfn

    rng = np.random.default_rng(m + o)
    jro, tro = _rollout_pair(rng, m, n1)
    jr, tr = random_risks(rng, m, o)
    jgrid = _random_grid(rng, o, g=32, fill=0.04)   # sparse: some paths stay outside
    want = np.asarray(jfn(jro, jgrid, jr, 0.1))
    got = trs.responsibility_reach_grid(tro, reach_grid_to_torch(jgrid), tr, 0.1)
    assert got.dtype == torch.float64 and got.shape == (m,)
    np.testing.assert_allclose(to_np(got), want, rtol=RTOL, atol=1e-300)
    if o:
        assert np.abs(want).max() > 0.0 and len(np.unique(want)) > 1


def test_responsibility_term_keeps_the_cost_dtype():
    """The 0/1 responsibility factor is built in the cost's dtype: float64
    stays float64, float32 stays float32."""
    rng = np.random.default_rng(1)
    for dtype in (torch.float64, torch.float32):
        _, tro = _rollout_pair(rng, 5, 11)
        tro.x, tro.y = tro.x.to(dtype), tro.y.to(dtype)
        _, tr = random_risks(rng, 5, 3)
        tr = type(tr)(*(f if f.dtype == torch.bool else f.to(dtype) for f in tr))
        grid = reach_grid_to_torch(_random_grid(rng, 3), dtype=dtype)
        assert trs.responsibility_reach_grid(tro, grid, tr, 0.1).dtype == dtype


# ---------------------------------------------------------- sector annulus


def _annulus_preds(rng, o, t):
    from frenetix_tpu.ops.costs import PredictionTensors as JPreds
    from frenetix_tpu_torch.ops.costs import PredictionTensors as TPreds

    f = dict(
        means=rng.normal(size=(o, t, 2)) * 8.0,
        inv_covs=np.zeros((o, t, 2, 2)), covs=np.zeros((o, t, 2, 2)),
        orientations=rng.uniform(-3.0, 3.0, (o, t)),
        velocities=rng.uniform(0.0, 12.0, (o, t)),
        lengths=np.full(o, 4.5), widths=np.full(o, 1.8),
        valid=rng.uniform(size=(o, t)) < 0.8,
    )
    return (JPreds(**{k: jnp_array(v) for k, v in f.items()}),
            TPreds(**{k: t64(v) for k, v in f.items()}))


@pytest.mark.parametrize("m,o,t,n1", [(40, 3, 12, 11), (64, 5, 8, 31)])
def test_sector_annulus_reach_sets_match_jax(m, o, t, n1):
    from frenetix_tpu.risk import reachable_set as jrs

    rng = np.random.default_rng(t)
    jp, tp = _annulus_preds(rng, o, t)
    jparams, tparams = jrs.reach_set_params(jp, dt=0.1), trs.reach_set_params(tp, dt=0.1)
    for k in jparams:
        np.testing.assert_allclose(to_np(tparams[k]), np.asarray(jparams[k]),
                                   rtol=RTOL, atol=1e-300, err_msg=k)
    pts = rng.normal(size=(m, t, 2)) * 10.0
    inside_j = np.asarray(jrs.point_in_reach_set(jnp_array(pts), jparams))
    inside_t = trs.point_in_reach_set(t64(pts), tparams)
    np.testing.assert_array_equal(to_np(inside_t), inside_j)
    assert 0 < inside_j.sum() < inside_j.size

    jro, tro = _rollout_pair(rng, m, n1)
    jr, tr = random_risks(rng, m, o)
    want = np.asarray(jrs.responsibility_reach_set(jro, jp, jr, dt=0.1))
    got = trs.responsibility_reach_set(tro, tp, tr, dt=0.1)
    np.testing.assert_allclose(to_np(got), want, rtol=RTOL, atol=1e-300)


# ------------------------------------------------------------- the planner


def _responsibility_config(make):
    cfg = make(dtype="float64")
    cfg.simulation.start_multiagent = True
    cfg.cost_weights["responsibility"] = 0.2
    # small tensors: the risk stack on one CPU thread is slow
    cfg.prediction.max_obstacles = 4
    cfg.debug.matrix_bucket = 64
    return cfg


def _parked_beside_the_road(factory, commonroad):
    """The highway with the lead far away and a car parked beside the lane,
    heading away from it: the ego passes within the 5 m risk gate but never
    enters the car's reach set, so the responsibility term is non-zero."""
    sc = factory.make_highway(lead_gap=120.0)
    sc.obstacles[300] = commonroad.Obstacle(
        obstacle_id=300, obstacle_type="car", role="static", length=4.5, width=1.8,
        initial_state=commonroad.State(0, np.array([35.0, 3.4]), np.pi / 2, 0.0))
    return sc


def test_planner_cycle_with_responsibility_matches_jax():
    """One replanning cycle from a pose 10 m down the road (the cycle at the
    very start of the road selects nothing and falls to the stopping
    ladder): the port selects the JAX planner's candidate at its cost."""
    import jax.numpy as jnp
    from frenetix_tpu.io import commonroad as jcr, scenario_factory as jfactory
    from frenetix_tpu.sim.agent import EgoState as JEgoState
    from frenetix_tpu.sim.prediction import to_device as jto_device
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig
    from frenetix_tpu_torch.io import commonroad as tcr
    from frenetix_tpu_torch.sim.agent import EgoState

    def config(make):
        cfg = _responsibility_config(make)
        cfg.simulation.start_multiagent = False
        return cfg

    jsim = JaxSimulation(_parked_beside_the_road(jfactory, jcr), config(JaxConfig))
    tsim = Simulation(_parked_beside_the_road(tfactory, tcr),
                      config(tconfig.FrenetixConfig), CPU)
    ja, ta = jsim.agents[0], tsim.agents[0]
    pose = dict(time_step=0, position=np.array([10.0, 0.0]), orientation=0.0,
                velocity=ta.state.velocity)
    ja.state, ta.state = JEgoState(**pose), EgoState(**pose)
    jpd, jids = jsim._predictions_for_step(0)
    tpd, tids = tsim._predictions_for_step(0)
    jp = jsim._agent_predictions(jpd, jids, ja)[0]
    tp = tsim._agent_predictions(tpd, tids, ta)[0]
    ja.interface.update_planner(jto_device(jp, jnp), jp["means"][:, 0],
                                jp["valid"][:, 0])
    jplan = ja.interface.step_interface()
    ta.update_planner(to_device(tp, CPU, torch.float64), tp["means"][:, 0],
                      tp["valid"][:, 0])
    tplan = ta.planner.plan(ta._rear_axle_state(), ta.ensure_x_cl())
    np.testing.assert_array_equal(to_np(ta.planner.reach_grid.occupancy),
                                  np.asarray(ja.planner.reach_grid.occupancy))
    assert tplan.mode == jplan.mode == "optimal"
    np.testing.assert_array_equal(tplan.sampling_parameters, jplan.sampling_parameters)
    np.testing.assert_allclose(tplan.cost, jplan.cost, rtol=RTOL)
    np.testing.assert_allclose(tplan.x, jplan.x, rtol=1e-9, atol=1e-9)
    # the selection cost holds the responsibility term: it differs from the
    # weighted sum of the logged terms by w·term
    term = tplan.cost - float(np.dot(to_np(ta.planner.weights), tplan.cost_terms))
    jterm = jplan.cost - float(np.dot(np.asarray(ja.planner.weights), jplan.cost_terms))
    assert term < -1e-5, term
    np.testing.assert_allclose(term, jterm, rtol=1e-6)


# ------------------------------------------------------- the batched cycle


A, DT, N, W = 4, 0.1, 30, 0.3


def _biting_problem():
    """The JAX tests' stacked problem with obstacle 0 of every agent moved
    next to the candidates' end points, and per-agent grids whose obstacle 0
    reaches only the +y half of its grid: the term varies per candidate."""
    import bench_scaling
    from frenetix_tpu.risk.reachable_set import ReachSetGrid as JGrid

    matrices, masks, jctx = bench_scaling.build_stacked_problem(
        A, dtype=np.float64, n_steps=N, spread=12.0)
    # every third candidate: the risk stack on one CPU thread is slow
    matrices, masks = matrices[:, ::3], masks[:, ::3]
    o = jctx.preds.means.shape[1]
    means = np.asarray(jctx.preds.means).copy()
    for i in range(A):
        means[i, 0, :, 0] = 40.0 + 12.0 * i
        means[i, 0, :, 1] = 5.0
    jctx = jctx._replace(preds=jctx.preds._replace(means=jnp_array(means)),
                         obstacle_xy=jnp_array(means[:, :, 0]))
    jgrids = []
    for i in range(A):
        occ = np.zeros((o, 11, 32, 32), bool)
        occ[0, :, :, 16:] = True
        valid = np.zeros(o, bool)
        valid[0] = True
        jgrids.append(JGrid(origin=jnp_array(means[i, :, 0]), occupancy=jnp_array(occ),
                            valid=jnp_array(valid), cell=jnp_array(np.full(o, 1.5)),
                            dt_rs=0.2))
    leaves = {f: getattr(jctx, f) for f in jctx._fields}
    leaves["ref"] = type(jctx.ref)(*(np.asarray(x) for x in jctx.ref))
    leaves["preds"] = {k: np.asarray(v) for k, v in jctx.preds._asdict().items()}
    tctx = context_from_numpy(**leaves, device=CPU, dtype=torch.float64)
    return matrices, masks, jctx, jgrids, tctx


def test_batched_full_cycle_with_responsibility_matches_jax():
    from frenetix_tpu.parallel.mesh import (
        batched_full_cycle as jbatched, stack_reach_grids as jstack,
    )

    matrices, masks, jctx, jgrids, tctx = _biting_problem()
    jout = jbatched(dt=DT, n_steps=N, resp_weight=W)(matrices, masks, jctx,
                                                     jstack(jgrids))
    jout = {k: np.asarray(v) for k, v in jout.items()}
    tm, tk = t64(matrices), torch.as_tensor(np.array(masks))
    tgrids = [reach_grid_to_torch(g) for g in jgrids]
    tout = tmesh.batched_full_cycle(dt=DT, n_steps=N, resp_weight=W)(
        tm, tk, tctx, tmesh.stack_reach_grids(tgrids))
    np.testing.assert_array_equal(to_np(tout["found"]), jout["found"])
    np.testing.assert_array_equal(to_np(tout["best"]), jout["best"])
    for key in ("x", "y", "v", "cost", "terms"):
        np.testing.assert_allclose(to_np(tout[key]), jout[key], rtol=1e-9, atol=1e-10,
                                   err_msg=key)

    # the batched post-pass equals the sequential one agent by agent, and
    # the term varies over the selectable candidates
    from frenetix_tpu_torch.planner.reactive import _responsibility

    spread = 0.0
    for a in range(A):
        ctx_a = tctx._replace(
            ref=type(tctx.ref)(*(f[a] for f in tctx.ref)),
            preds=type(tctx.preds)(*(f[a] for f in tctx.preds)),
            **{k: getattr(tctx, k)[a] for k in (
                "obstacle_xy", "obstacle_valid", "corridor", "lane_segments",
                "lane_valid", "x0_orientation", "desired_velocity",
                "desired_avg_velocity")})
        res = teval(tm[a], tk[a], ctx_a, dt=DT, n_steps=N, low_vel_mode=False)
        cost, best = _responsibility(
            res.rollout, ctx_a.preds,
            meta_from_footprint(ctx_a.preds.lengths, ctx_a.preds.widths), tgrids[a],
            res.cost, res.selectable, res.best_idx, w=W, dt=DT, mass=tctx.veh.mass)
        assert int(best) == int(tout["best"][a])
        assert float(cost[int(best)]) == float(tout["cost"][a])
        term = to_np(cost - res.cost)[to_np(res.selectable)]
        spread = max(spread, float(np.ptp(term)))
    assert spread > 0.0


def test_batched_cycle_needs_its_extras():
    from frenetix_tpu_torch.parallel.batched_sim import BatchedAgentStepper

    cfg = _responsibility_config(tconfig.FrenetixConfig)
    sim = Simulation(tfactory.make_highway(n_steps=80), cfg, CPU)
    stepper = BatchedAgentStepper(cfg, sim.agents, CPU)
    assert stepper.resp_weight == 0.2 and not stepper.use_occlusion
    with pytest.raises(ValueError, match="reach grids"):
        stepper.step(np.zeros((2, 64, 13)), np.zeros((2, 64), bool), None,
                     np.zeros(2), np.zeros(2), cfg.vehicle, None)


# -------------------------------------------------------------- simulation


STEPS = 18


@pytest.fixture(scope="module")
def sequential_responsibility_run():
    sim = Simulation(tfactory.make_highway(n_steps=80),
                     coarse_sampling(_responsibility_config(tconfig.FrenetixConfig)), CPU)
    sim.max_steps = STEPS
    return sim.run(), agent_states(sim)


def test_responsibility_simulation_matches_jax(sequential_responsibility_run):
    from frenetix_tpu.io.scenario_factory import make_highway as jmake
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    jsim = JaxSimulation(jmake(n_steps=80),
                         coarse_sampling(_responsibility_config(JaxConfig)))
    jsim.max_steps = STEPS
    jres = jsim.run()
    res, states = sequential_responsibility_run
    assert res.steps == jres.steps == STEPS
    for aid, want in agent_states(jsim).items():
        assert states[aid].shape == want.shape
        np.testing.assert_allclose(states[aid], want, atol=1e-9)


def test_responsibility_simulation_batched_equals_sequential(
        sequential_responsibility_run):
    cfg = coarse_sampling(_responsibility_config(tconfig.FrenetixConfig))
    cfg.simulation.batched_device_agents = True
    sim = Simulation(tfactory.make_highway(n_steps=80), cfg, CPU)
    sim.max_steps = STEPS
    res = sim.run()
    seq, seq_states = sequential_responsibility_run
    assert res.steps == seq.steps and res.agent_status == seq.agent_status
    for aid, want in seq_states.items():
        np.testing.assert_allclose(agent_states(sim)[aid], want, atol=1e-9)
    assert sim._batched_stepper.resp_weight == 0.2
    assert sim._dummy_reach_grid is not None
    assert not bool(sim._dummy_reach_grid.valid.any())
    assert any(a.record.batch_planning_times for a in sim.agents)
