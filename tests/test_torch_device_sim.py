"""The port's device-resident run (`frenetix_tpu_torch.parallel.device_sim`).

Against the JAX package at float64 on the CPU, same inputs from numpy seeds:
the sampling matrix built on the device, the goal check and the desired
velocity on random states, the stopping fallback's rank key on matrices with
ties, and one whole run of the factory highway (equal `status`, `steps`,
`found`; `trajectories` and `selections` within 1e-9).

Against the port's own host `Simulation` (which other files hold against the
JAX package to 1e-9 m): single-agent and `min_risk` highway, the two-agent
overtake in both prediction modes (sequential host order), the collision
sweep's order, two densification levels, a low-velocity start, the adapter
to `SimulationResult`, the guards and the entry points.

Tolerance 1e-9 m throughout: both sides run the same float64 operations on
the same inputs; what differs is the order of sums over obstacle rows (the
run appends peer rows, the host fills free slots), worth ~1e-13 m over a run.
Scenarios are shortened with `make_*(n_steps=...)` and sampled at level 1
(`coarse_sampling`), so that the file stays inside its time budget.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.ops import sampling as tsmp
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.planner.reactive import ReactivePlanner
from frenetix_tpu_torch.sim.agent import AgentStatus
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig
from torch_parity import CPU, coarse_sampling, host_count, to_np

torch.set_num_threads(1)

ATOL = 1e-9


def _tcfg(coarse=True, **overrides):
    cfg = tconfig.load_config(overrides=overrides, strict_overrides=True)
    cfg.dtype = "float64"
    return coarse_sampling(cfg) if coarse else cfg


def _device_and_host(make, cfg):
    """(DeviceSimulation, its result, the sequential host run's result)."""
    ds = tds.DeviceSimulation(Simulation(make(), cfg, CPU))
    return ds, ds.run(), Simulation(make(), cfg, CPU).run()


def _assert_equals_host(dres, hres):
    assert dres.steps == hres.steps
    assert [int(s) for s in dres.status] == [int(hres.agent_status[a])
                                            for a in dres.agent_ids]
    for col, aid in enumerate(dres.agent_ids):
        hist = hres.histories[aid]           # hist[i] = state after step i
        pos = np.array([s.position for s in hist[1:]])
        vel = np.array([s.velocity for s in hist[1:]])
        np.testing.assert_allclose(dres.trajectories[:len(pos), col, :2], pos,
                                   atol=ATOL, err_msg=f"agent {aid}")
        np.testing.assert_allclose(dres.trajectories[:len(vel), col, 3], vel,
                                   atol=ATOL, err_msg=f"agent {aid}")


# --------------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def both_packages():
    """The same shortened highway as a device-resident simulation of both
    packages (constructed, not run)."""
    from frenetix_tpu.io.scenario_factory import make_highway as jmake
    from frenetix_tpu.parallel.device_sim import DeviceSimulation as JDeviceSim
    from frenetix_tpu.sim import Simulation as JSimulation
    from frenetix_tpu.utils.config import load_config as jload

    jcfg = jload()
    jcfg.dtype = "float64"
    coarse_sampling(jcfg)
    jds = JDeviceSim(JSimulation(jmake(n_steps=120), jcfg))
    tsim = tds.DeviceSimulation(
        Simulation(tfactory.make_highway(n_steps=120), _tcfg(), CPU))
    return jds, tsim


def test_host_tensors_match_jax(both_packages):
    """Every SimTensors leaf of this slice equals the JAX package's."""
    jds, tsim = both_packages
    jg, tg = jds.tensors, tsim.tensors
    for name in ("corridors", "lane_segments", "lane_valid", "cur_obst",
                 "cur_obst_valid", "obst_poses", "obst_valid", "obst_half", "g_rings",
                 "g_ring_valid", "g_ring_v", "g_vo_has", "g_vo_int", "goal_s",
                 "has_goal_s", "goal_t_hi", "has_goal_t", "goal_v_mean", "max_steps",
                 "active0", "x_cl0", "pose0", "acc0", "bank0", "bank_len0"):
        a, b = to_np(getattr(jg, name)), np.asarray(getattr(tg, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name in tg.ref._fields:
        np.testing.assert_allclose(getattr(tg.ref, name), to_np(getattr(jg.ref, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name, leaf in tg.pred_windows.items():
        np.testing.assert_allclose(np.asarray(leaf, dtype=np.float64),
                                   to_np(jg.pred_windows[name]).astype(np.float64),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert tsim.n_cycles == jds.n_cycles and tsim.bank_w == jds.bank_w
    assert [lvl[3] for lvl in tsim.levels] == [lvl[3] for lvl in jds.levels]


def test_sampling_matrix_matches_jax(both_packages):
    """The device-built matrix equals the JAX package's bit for bit at
    float64 (both follow np.linspace's algorithm), on random states."""
    import jax.numpy as jnp

    jds, tsim = both_packages
    rng = np.random.default_rng(0)
    x_cl = rng.normal(size=(5, 6)) * np.array([30.0, 3.0, 1.0, 1.0, 0.3, 0.1])
    x_cl[:, 1] = np.abs(x_cl[:, 1]) + 0.5
    v = rng.uniform(0.0, 25.0, 5)
    t_grid, n_v, n_d, m = tsim.levels[0]
    p = tsim.config.planning
    got = tds.build_sampling_matrices(
        torch.as_tensor(x_cl), torch.as_tensor(v), torch.as_tensor(t_grid), n_v, n_d,
        veh=tsim.veh, horizon=tsim.horizon, d_min=p.d_min, d_max=p.d_max,
        d_ego_pos=False).numpy()
    assert got.shape == (5, m, 13)
    build = jds._build_matrix_fn(0)
    for i in range(5):
        want = to_np(build(jnp.asarray(x_cl[i]), jnp.asarray(v[i])))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d_ego_pos", [False, True])
@pytest.mark.parametrize("level", [1, 2])
def test_sampling_matrix_rows_are_the_host_rows(dtype, d_ego_pos, level):
    """Bitwise the rows of the host's `_sampling_ranges` +
    `build_sampling_matrix` for the same state, in both working types; the
    device appends the current ṡ and d where the host unions them in, so a
    value that is already on a grid gives duplicate rows."""
    cfg = tconfig.load_config(overrides={"planning": {"d_ego_pos": d_ego_pos}})
    cfg.dtype = dtype
    planner = ReactivePlanner(cfg, CPU)
    np_dtype = planner.np_dtype
    p = cfg.planning
    rng = np.random.default_rng(level)
    t1 = tsmp.time_samples(p.t_min, p.planning_horizon, p.dt, level)
    t1 = np.unique(np.concatenate([t1, [p.n_steps * p.dt]]))
    n_v = len(tsmp.linspace_samples(0.0, 1.0, level))
    n_d = len(tsmp.linspace_samples(p.d_min, p.d_max, level))
    for case in range(6):
        # states in the working type, as the run carries them
        x_cl = (rng.normal(size=6) * np.array([30.0, 3.0, 1.0, 1.0, 0.3, 0.1])
                ).astype(np_dtype)
        x_cl[1] = abs(x_cl[1]) + np_dtype(0.5)
        v = np_dtype(rng.uniform(0.0, 50.0))
        if case == 0:
            x_cl[3] = 0.0           # the current d lies on the lateral grid
        if case == 1:
            v = np_dtype(0.05)      # the lower clip at 0.001 m/s
        if case == 2:
            v = np_dtype(49.0)      # the upper clip at v_max
        got = tds.build_sampling_matrices(
            torch.as_tensor(x_cl)[None], torch.as_tensor(v)[None],
            torch.as_tensor(t1.astype(np_dtype)), n_v, n_d, veh=cfg.vehicle,
            horizon=p.planning_horizon, d_min=p.d_min, d_max=p.d_max,
            d_ego_pos=d_ego_pos)[0].numpy()
        assert got.dtype == np_dtype
        assert got.shape == (len(t1) * (n_v + 1) * (n_d + 1), 13)
        planner.current_velocity = float(v)
        x_pair = (x_cl[:3], x_cl[3:])
        t1_h, ss1, d1 = planner._sampling_ranges(level, x_pair)
        want = tsmp.build_sampling_matrix(t1_vals=t1_h, ss1_vals=ss1, d1_vals=d1,
                                          x0_lon=x_pair[0], x0_lat=x_pair[1],
                                          dtype=np_dtype)
        if d_ego_pos and dtype == "float32":
            # here the host's own grid depends on NumPy's promotion rules
            # (float32 scalar + Python float, then np.linspace: float32
            # under NumPy 2, float64 under NumPy 1), so the lateral column is
            # held to 2 float32 ulps of the values' magnitude, the rest bitwise
            cols = [c for c in range(13) if c != 10]
            np.testing.assert_array_equal(np.unique(got[:, cols], axis=0),
                                          np.unique(want[:, cols], axis=0))
            d_got, d_want = np.unique(got[:, 10]), np.unique(want[:, 10])
            tol = 2 * np.spacing(np.float32(np.abs(d_want).max()))
            for a, b in ((d_got, d_want), (d_want, d_got)):
                assert np.abs(a[:, None] - b[None, :]).min(axis=1).max() <= tol
            continue
        # the same set of rows, bit for bit (np.unique sorts both)
        np.testing.assert_array_equal(np.unique(got, axis=0), np.unique(want, axis=0))


def test_goal_check_matches_jax_and_the_agent(both_packages):
    import jax.numpy as jnp

    jds, tsim = both_packages
    agent = tsim.agents[0]
    ring = agent.problem.goals[0].position_shape
    if ring is None:
        lid = agent.problem.goals[0].position_lanelets[0]
        ring = agent.scenario.lanelets[lid].polygon
    lo, hi = np.min(ring, axis=0), np.max(ring, axis=0)
    rng = np.random.default_rng(1)
    centers = rng.uniform(lo - 3.0, hi + 3.0, size=(200, 2))
    vels = rng.uniform(0.0, 30.0, 200)
    g = tsim.tensors.to(CPU, torch.float64)
    jcheck = jds._goal_check_fn()
    got, want, host = [], [], []
    for c, v in zip(centers, vels):
        got.append(bool(tds.goal_check(g, torch.as_tensor(c)[None],
                                       torch.as_tensor(v)[None])[0]))
        want.append(bool(jcheck(jds.tensors, jnp.asarray(c)[None],
                                jnp.asarray(v)[None])[0]))
        agent.state.position, agent.state.velocity = c, float(v)
        host.append(agent.goal_reached())
    assert got == want == host
    assert 20 < sum(got) < 180          # both outcomes occur


def test_desired_velocity_matches_jax_and_the_agent(both_packages):
    import jax.numpy as jnp

    jds, tsim = both_packages
    agent = tsim.agents[0]
    g = tsim.tensors.to(CPU, torch.float64)
    jfn = jds._desired_velocity_fn()
    rng = np.random.default_rng(2)
    goal_s = float(tsim.tensors.goal_s[0])
    for case in range(100):
        x_cl = np.zeros(6)
        # around and beyond the goal, so that every branch is taken
        x_cl[0] = rng.uniform(goal_s - 200.0, goal_s + 5.0) if case % 4 \
            else rng.uniform(goal_s - 2.5, goal_s + 1.0)
        v = rng.uniform(0.0, 30.0)
        step = int(rng.integers(0, 400))
        got = float(tds.desired_velocity(
            g, torch.as_tensor(x_cl)[None], torch.tensor([v], dtype=torch.float64),
            torch.tensor([float(step)], dtype=torch.float64), tsim.dt)[0])
        want = float(jfn(jds.tensors, jnp.asarray(x_cl)[None], jnp.asarray(v)[None],
                         jnp.asarray(float(step)))[0])
        agent.x_cl = (x_cl[:3], x_cl[3:])
        agent.state.velocity, agent.state.time_step = float(v), step
        assert got == pytest.approx(want, abs=1e-12)
        assert got == pytest.approx(agent.desired_velocity(), abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stopping_rank_key_selects_what_the_host_selects(seed):
    """argmin of the int64 rank key over the feasible candidates picks the
    candidate `_select_stopping_index` picks (of both packages), on random
    matrices whose d grid is symmetric about the current d (ties in
    |d - d0|) and with duplicate rows appended (ties in every rank)."""
    from frenetix_tpu.planner.reactive import ReactivePlanner as JPlanner

    rng = np.random.default_rng(seed)
    d0 = float(rng.normal())
    t1 = np.round(np.sort(rng.choice(np.arange(11, 31), 5, replace=False)) * 0.1, 2)
    ss1 = np.sort(rng.uniform(0.0, 20.0, 6))
    d1 = d0 + np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
    matrix = tsmp.build_sampling_matrix(
        t1_vals=t1, ss1_vals=ss1, d1_vals=d1, x0_lon=(0.0, 5.0, 0.0),
        x0_lat=(d0, 0.0, 0.0))
    n_base = len(matrix)
    copies = rng.integers(0, n_base, 20)
    matrix = np.concatenate([matrix, matrix[copies]])
    key = tds.stopping_rank_key(torch.as_tensor(matrix)[None],
                                torch.tensor([d0], dtype=torch.float64))[0]
    assert key.dtype == torch.int64
    big = torch.iinfo(torch.int64).max
    for _ in range(25):
        # a duplicate is the same candidate: it is as feasible as its source
        feas = rng.uniform(size=n_base) < rng.uniform(0.02, 0.5)
        feas = np.concatenate([feas, feas[copies]])
        if not feas.any():
            continue
        got = int(torch.argmin(torch.where(torch.as_tensor(feas), key,
                                           torch.full_like(key, big))))
        want = ReactivePlanner._select_stopping_index(matrix, feas, d0)
        assert want == JPlanner._select_stopping_index(matrix, feas, d0)
        assert feas[got]
        # duplicates are the same candidate under another index
        np.testing.assert_array_equal(matrix[got], matrix[want])


def test_stopping_rank_key_does_not_overflow_int32():
    """From M = 1291 on the key passes 2^31."""
    m = 1400
    matrix = np.zeros((m, 13))
    matrix[:, 5] = np.arange(m)            # rank(v) = row index
    matrix[:, 1] = np.arange(m)[::-1]
    matrix[:, 10] = np.arange(m) % 7
    key = tds.stopping_rank_key(torch.as_tensor(matrix), torch.zeros(()))
    assert int(key.max()) > 2**31 and int(key.min()) >= 0
    assert torch.equal(torch.argsort(key), torch.arange(m))


def test_ties_break_to_the_first_index():
    key = torch.tensor([5, 3, 3, 9, 3], dtype=torch.int64)
    assert int(torch.argmin(key)) == 1
    assert int(torch.argmin(key.double())) == 1


def test_whole_run_matches_jax(both_packages):
    """`DeviceSimulation(Simulation(make_highway(...), cfg)).run()` of both
    packages: the JAX scan against the port's eager loop."""
    jds, tsim = both_packages
    jres, tres = jds.run(), tsim.run()
    np.testing.assert_array_equal(tres.status, np.asarray(jres.status))
    assert tres.steps == jres.steps
    np.testing.assert_array_equal(tres.found, np.asarray(jres.found))
    # cycle 0 selects nothing and takes the ladder; cycle 1 selects
    assert not tres.found[0, 0] and tres.found[1, 0]
    np.testing.assert_array_equal(tres.status_per_step,
                                  np.asarray(jres.status_per_step))
    np.testing.assert_allclose(tres.trajectories, np.asarray(jres.trajectories),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tres.selections, np.asarray(jres.selections),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tres.extras["x_cl_cycles"],
                               np.asarray(jres.extras["x_cl_cycles"]), rtol=0, atol=ATOL)
    # on the CPU the run is eager and goes through K1's plain twin
    assert tres.extras["graph"] is False and tres.extras["k1_launches"] == 0


# ------------------------------------------------ against the port's host run


def test_single_agent_highway_matches_host():
    ds, dres, hres = _device_and_host(tfactory.make_highway, _tcfg())
    assert hres.agent_status[60000] == AgentStatus.COMPLETED_SUCCESS
    _assert_equals_host(dres, hres)
    # the ladder ran: cycle 0 of the factory highway selects nothing
    assert not dres.found[0, 0] and dres.found[1, 0]
    assert dres.trajectories.shape == (ds.max_steps, 1, 5)
    assert dres.selections.shape == (ds.n_cycles, 1, 3)


def test_min_risk_highway_matches_host():
    """emergency_mode = "min_risk": cycle 0 has no selectable candidate and
    takes the feasible one of lowest ego + obstacle risk.  One obstacle slot
    and a short run: the risk stack runs every cycle here, and costs seconds
    per call on one CPU thread at 16 slots."""
    cfg = _tcfg(planning={"emergency_mode": "min_risk"},
                prediction={"max_obstacles": 1})
    _, dres, hres = _device_and_host(lambda: tfactory.make_highway(n_steps=24), cfg)
    _assert_equals_host(dres, hres)
    assert not dres.found[0, 0] and dres.found[1, 0]


@pytest.fixture(scope="module")
def overtake_two_agents():
    cfg = _tcfg(simulation={"start_multiagent": True})
    return _device_and_host(tfactory.make_overtake, cfg)


def test_two_agent_overtake_ground_truth_matches_sequential_host(overtake_two_agents):
    ds, dres, hres = overtake_two_agents
    assert len(ds.agents) == 2 and hres.success
    _assert_equals_host(dres, hres)


def test_two_agent_overtake_constant_velocity_matches_sequential_host():
    cfg = _tcfg(simulation={"start_multiagent": True},
                prediction={"mode": "constant_velocity"})
    _, dres, hres = _device_and_host(lambda: tfactory.make_overtake(n_steps=120), cfg)
    _assert_equals_host(dres, hres)


def test_to_simulation_result_mirrors_the_host_recording(overtake_two_agents):
    ds, dres, hres = overtake_two_agents
    adapted = ds.to_simulation_result(dres)
    assert adapted.success and adapted.steps == hres.steps
    assert adapted.agent_status == hres.agent_status
    assert adapted.agent_messages == hres.agent_messages
    for aid in dres.agent_ids:
        ha, hh = adapted.histories[aid], hres.histories[aid]
        assert len(ha) == len(hh), aid
        np.testing.assert_allclose(ha[-1].position, hh[-1].position, atol=ATOL)
        np.testing.assert_allclose(ha[3].velocity, hh[3].velocity, atol=ATOL)
        assert [s.time_step for s in ha] == [s.time_step for s in hh]


def test_collision_sweep_matches_host_order():
    """Two agents that overlap each other (overtake, gap 58, level-1
    sampling: the rear agent runs into the lead): the host's in-order sweep
    marks only the first agent, and the partner drives on to its goal."""
    cfg = _tcfg(simulation={"start_multiagent": True})
    _, dres, hres = _device_and_host(lambda: tfactory.make_overtake(lead_gap=58.0), cfg)
    statuses = [int(s) for s in dres.status]
    assert statuses.count(int(AgentStatus.COLLISION)) == 1
    assert statuses.count(int(AgentStatus.COMPLETED_SUCCESS)) == 1
    _assert_equals_host(dres, hres)


def test_two_densification_levels_match_host():
    """sampling_min, sampling_max = 1, 3: both levels run every cycle and the
    first that found a candidate wins, which is where the host stops."""
    cfg = _tcfg(coarse=False, planning={"sampling_min": 1, "sampling_max": 3})
    ds, dres, hres = _device_and_host(lambda: tfactory.make_highway(n_steps=60), cfg)
    assert len(ds.levels) == 2
    _assert_equals_host(dres, hres)


def test_low_velocity_start_takes_the_lo_kinematics_merge():
    cfg = _tcfg()
    make = lambda: tfactory.make_highway(ego_v=1.5, lead_v=4.0, n_steps=90)  # noqa: E731
    _, dres, hres = _device_and_host(make, cfg)
    v_replan = dres.extras["x_cl_cycles"][:, 0, 1]
    thr = cfg.planning.low_vel_mode_threshold
    # cycles on both sides of the threshold, with candidates found on both
    assert (dres.found[:, 0] & (v_replan < thr)).any()
    assert (dres.found[:, 0] & (v_replan >= thr)).any()
    _assert_equals_host(dres, hres)


# ------------------------------------------------------ guards, entry points


@pytest.mark.parametrize("field,value,slice_name", [
    (("occlusion", "use_occlusion_module"), True, "host-loop only"),
])
def test_options_of_later_slices_raise_in_the_device_run(field, value, slice_name):
    """Wale-Net predictions with the occlusion module raise, as in the JAX
    package (its device run threads no host phantom geometry)."""
    sim = Simulation(tfactory.make_highway(n_steps=30), _tcfg(), CPU)
    sim.config.prediction.mode = "walenet"
    section, name = field
    setattr(getattr(sim.config, section), name, value)
    with pytest.raises(NotImplementedError, match=slice_name):
        tds.DeviceSimulation(sim)


@pytest.mark.parametrize("behavior", [False, True])
def test_walenet_constructs_the_hybrid_prediction_path(behavior, tmp_path, monkeypatch):
    """A walenet device run builds no prediction window (the net is not
    loaded at construction: a missing export raises only when the run
    starts), and with behavior its FSM stays on the host."""
    from frenetix_tpu_torch.models import walenet

    monkeypatch.setattr(walenet, "WALENET_ONNX_PATH", str(tmp_path / "absent.onnx"))
    walenet._WALENET_CACHE.clear()
    cfg = _tcfg(prediction={"mode": "walenet"},
                behavior={"use_behavior_planner": behavior})
    ds = tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=30), cfg, CPU))
    assert ds.hybrid_pred and not ds.fsm_in_scan
    assert not ds.tensors.pred_windows["valid"].any()
    if behavior:
        assert ds.fsm_reason == "walenet predictions run on the hybrid path"
    with pytest.raises(FileNotFoundError):
        ds.run()


@pytest.mark.parametrize("field,value,flag", [
    (("cost_weights", "responsibility"), 0.5, "resp_weight"),
    (("prediction", "calc_occlusions"), True, "use_vis_occl"),
    (("occlusion", "use_occlusion_module"), True, "use_occlusion"),
    (("behavior", "use_behavior_planner"), True, "resp_weight"),
])
def test_post_pass_options_construct_in_the_device_run(field, value, flag):
    """The options of slice 6b build their device run (they raised before
    it); a behavior run takes the responsibility term along."""
    sim = Simulation(tfactory.make_highway(n_steps=30), _tcfg(), CPU)
    if field[0] == "behavior":
        sim.config.cost_weights["responsibility"] = 0.5
    section, name = field
    if section == "cost_weights":
        sim.config.cost_weights[name] = value
    else:
        setattr(getattr(sim.config, section), name, value)
    ds = tds.DeviceSimulation(sim)
    assert getattr(ds, flag)
    assert ds.need_risks == (flag != "use_vis_occl")


def test_a_mesh_raises_in_the_device_run():
    """A mesh that the agents do not divide over raises the JAX package's
    ValueError, before any collective (a stand-in with `size()` suffices)."""
    class ThreeRanks:
        def size(self):
            return 3

    sim = Simulation(tfactory.make_highway(n_steps=30),
                     _tcfg(simulation={"start_multiagent": True}), CPU)
    assert len(sim.agents) == 2
    with pytest.raises(ValueError, match="agent count 2 must divide evenly over the 3"):
        tds.DeviceSimulation(sim, mesh=ThreeRanks())


@pytest.mark.parametrize("section,name", [("prediction", "mode"),
                                          ("planning", "emergency_mode")])
def test_unknown_modes_raise_value_error(section, name):
    sim = Simulation(tfactory.make_highway(n_steps=30), _tcfg(), CPU)
    setattr(getattr(sim.config, section), name, "bogus")
    with pytest.raises(ValueError, match="bogus"):
        tds.DeviceSimulation(sim)


@pytest.mark.parametrize("override", [
    {"cost_weights": {"responsibility": 0.5}},
    {"prediction": {"calc_occlusions": True}},
    {"occlusion": {"use_occlusion_module": True}},
])
def test_those_options_still_run_on_the_host_path(override):
    cfg = _tcfg(**override)
    cfg.prediction.max_obstacles = 2
    sim = Simulation(tfactory.make_highway(n_steps=30), cfg, CPU)
    sim.max_steps = 6
    res = sim.run()
    assert res.steps == 6
    # and in the device-resident run (slice 6b), to the same end
    cfg.simulation.device_resident_sim = True
    dsim = Simulation(tfactory.make_highway(n_steps=30), cfg, CPU)
    dsim.max_steps = 6
    dres = dsim.run()
    assert dres.steps == 6 and dres.agent_status == res.agent_status
    np.testing.assert_allclose(dres.histories[60000][-1].position,
                               res.histories[60000][-1].position, atol=ATOL)


def test_device_run_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        sim = Simulation(tfactory.make_highway(n_steps=30), _tcfg())
        assert tds.DeviceSimulation(sim).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=30), _tcfg()))
    # an explicit CPU device is taken, from the simulation or the argument
    sim = Simulation(tfactory.make_highway(n_steps=30), _tcfg(), CPU)
    assert tds.DeviceSimulation(sim).device.type == "cpu"
    assert tds.DeviceSimulation(sim, device="cpu").device.type == "cpu"


def test_simulation_run_honours_device_resident_sim():
    make = lambda: tfactory.make_highway(n_steps=60)  # noqa: E731
    cfg = _tcfg(simulation={"device_resident_sim": True})
    fetches = host_count("device_sim.fetches")
    res = Simulation(make(), cfg, CPU).run()
    assert host_count("device_sim.fetches") == fetches + 1      # one fetch per run
    host = Simulation(make(), _tcfg(), CPU).run()
    assert res.steps == host.steps and res.agent_status == host.agent_status
    assert res.planning_times == []
    np.testing.assert_allclose(res.histories[60000][-1].position,
                               host.histories[60000][-1].position, atol=ATOL)


def test_run_scenario_device_sim_and_fleet_on_cpu(tmp_path, capsys, monkeypatch):
    from frenetix_tpu_torch import run_scenario

    def small_config(config_dir=None):
        return _tcfg()

    monkeypatch.setattr(run_scenario, "load_config", small_config)
    assert run_scenario.main(["highway", "--device", "cpu", "--device-sim",
                              "--logs", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "SYN_Highway-1 agent=60000 status=COMPLETED_SUCCESS steps=197" in out
    assert run_scenario.main(["highway", "curve", "--device", "cpu", "--device-fleet",
                              "--chunk", "2", "--logs", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "SYN_Highway-1 agent=60000 status=COMPLETED_SUCCESS steps=197" in out
    assert "SYN_Curve-1 agent=60000 status=COMPLETED_SUCCESS" in out
    rows = (tmp_path / "score_overview.csv").read_text().splitlines()
    assert rows[0] == "scenario;agent;timestep;status;message;wall_s"
    assert len(rows) == 4 and rows[1].startswith("SYN_Highway-1;60000;197;")


@pytest.mark.cuda
def test_a_replayed_run_with_the_risk_stack_counts_as_its_eager_run():
    """`min_risk` prices every cycle's candidates with kernel Q, so the
    replayed run moves `risk.quadrature.cells` and `kernel.q.launches` by
    what its eager run moves them (the capture's and the warm-up's counts
    are set-up), and returns the eager run's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    names = ("risk.quadrature.cells", "kernel.q.launches", "kernel.k1.launches")
    cfg = _tcfg(planning={"emergency_mode": "min_risk"},
                prediction={"max_obstacles": 1})
    ds = tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=24), cfg,
                                         torch.device("cuda", 0)))
    counts, results = {}, {}
    for graph in (False, True):
        before = {name: host_count(name) for name in names}
        results[graph] = ds.run(graph=graph)
        counts[graph] = {name: host_count(name) - before[name] for name in names}
    assert counts[True] == counts[False]
    q = counts[False]["kernel.q.launches"]
    assert q > 0 and q % ds.n_cycles == 0 and counts[False]["risk.quadrature.cells"] > 0
    for name in ("status", "trajectories", "selections", "found"):
        np.testing.assert_array_equal(getattr(results[True], name),
                                      getattr(results[False], name), err_msg=name)
