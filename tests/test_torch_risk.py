"""The port's risk stack and min_risk selection against the JAX package,
float64 on the CPU.

Inputs are made from a seed with NumPy and go through the JAX function and
its counterpart in `frenetix_tpu_torch.risk`:

- `bvn_cdf`, `rectangle_probability`: rtol 1e-12 with an absolute floor of
  1e-15 (a rectangle probability is a difference of four CDF values of
  order 1, so its last bits are round-off of the summation order);
- `collision_probability_fast`, `inv_mahalanobis`, `normalize_probability`,
  every harm function in every angle variant, `angle_range`,
  `meta_from_footprint`, `ObstacleMeta.from_obstacles`: rtol 1e-10;
- `trajectory_risks` in four mode sets: rtol 1e-10 (absolute floor 1e-14 for
  the probability's cancellation);
- chunking over candidates changes no bit; a CPU call builds and loads no
  kernel, raises on mixed dtypes or devices before anything runs, and
  counts every (agent, candidate, obstacle, step) cell it visits;
- a planner cycle in which every candidate collides ends in min_risk and
  selects the JAX planner's index; `debug.log_risk` reports the same risks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frenetix_tpu.ops import kinematics as jkin
from frenetix_tpu.ops.costs import PredictionTensors as JPreds
from frenetix_tpu.ops.sampling import build_sampling_matrix
from frenetix_tpu.risk import costs as jrc
from frenetix_tpu.risk import harm as jharm
from frenetix_tpu.risk import probability as jprob
from frenetix_tpu_torch.ops import _kernels
from frenetix_tpu_torch.ops.costs import PredictionTensors as TPreds
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.risk import costs as trc
from frenetix_tpu_torch.risk import harm as tharm
from frenetix_tpu_torch.risk import probability as tprob
from frenetix_tpu_torch.utils import tracing

from tests.torch_parity import CPU, curved_ref_np, host_count, t64, to_np, torch_rollout

torch.set_num_threads(1)

DT, N = 0.1, 30
RTOL = 1e-10


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ----------------------------------------------------------------- probability


def test_bvn_cdf_matches_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(0, 2, 4000), rng.normal(0, 2, 4000)
    rho = rng.uniform(-0.99, 0.99, 4000)
    rho[:200] = 0.0
    _close(tprob.bvn_cdf(t64(x), t64(y), t64(rho)),
           jprob.bvn_cdf(jnp.asarray(x), jnp.asarray(y), jnp.asarray(rho)),
           rtol=1e-12, atol=1e-15)
    # broadcasting of a scalar correlation
    _close(tprob.bvn_cdf(t64(x), t64(y), t64(0.3)),
           jprob.bvn_cdf(jnp.asarray(x), jnp.asarray(y), 0.3), rtol=1e-12, atol=1e-15)


def test_rectangle_probability_matches_jax():
    rng = np.random.default_rng(1)
    n = 3000
    lower = rng.normal(0, 2, (n, 2))
    upper = lower + rng.uniform(0.1, 4.0, (n, 2))
    mean = rng.normal(0, 2, (n, 2))
    a = rng.normal(size=(n, 2, 2))
    cov = a @ a.transpose(0, 2, 1) + 0.05 * np.eye(2)
    got = tprob.rectangle_probability(t64(lower), t64(upper), t64(mean), t64(cov))
    want = jprob.rectangle_probability(*(jnp.asarray(v) for v in (lower, upper, mean, cov)))
    _close(got, want, rtol=1e-12, atol=1e-15)
    assert float(got.max()) > 0.3 and float(got.min()) >= 0.0


def test_normalize_probability_matches_jax():
    p = np.concatenate([10.0 ** np.linspace(-80, 0, 400),
                        [0.0, 1e-70, 1e-10, 1e-4, 1e-2, 1e-1, 1.0]])
    _close(tprob.normalize_probability(t64(p)),
           jprob.normalize_probability(jnp.asarray(p)), rtol=1e-14)


@pytest.fixture(scope="module")
def risk_inputs():
    """A rollout that drives into four predicted obstacles (one invalid from
    step 20 on, one absent, one pedestrian-sized), with correlated
    covariances, and a zero covariance on one row."""
    ref = curved_ref_np()
    matrix = build_sampling_matrix(
        t1_vals=[1.5, 2.2, 3.0], ss1_vals=[4.0, 8.0, 12.0, 15.0],
        d1_vals=[-2.0, -0.7, 0.4, 1.5], x0_lon=(35.0, 10.0, 0.2),
        x0_lat=(0.4, 0.05, 0.01))
    jro = jkin.rollout_candidates(
        jnp.asarray(matrix), ref, jkin.VehicleParams(), dt=DT, n_steps=N,
        low_vel_mode=False, x0_orientation=0.35)
    rng = np.random.default_rng(2)
    o, t = 5, N
    s_obs = 44.0 + 6.0 * np.arange(o)[:, None] + 4.0 * DT * np.arange(t)[None, :]
    means = np.stack([np.interp(s_obs, ref.s, ref.xy[:, 0]),
                      np.interp(s_obs, ref.s, ref.xy[:, 1])], axis=-1)
    means += rng.normal(0, 0.4, means.shape)
    a = rng.normal(0, 0.5, size=(o, t, 2, 2))
    covs = a @ a.transpose(0, 1, 3, 2) + 0.2 * np.eye(2)
    covs[3] = 0.0                                  # ground truth: falls back
    valid = np.ones((o, t), bool)
    valid[1, 20:] = False
    valid[4] = False
    preds = dict(
        means=means, covs=covs,
        inv_covs=np.linalg.inv(covs + (np.abs(covs).sum((-2, -1), keepdims=True) == 0)
                               * np.eye(2)),
        orientations=np.interp(s_obs, ref.s, ref.theta) + rng.normal(0, 0.2, (o, t)),
        velocities=rng.uniform(2, 9, (o, t)),
        lengths=np.array([4.5, 4.8, 0.5, 2.0, 4.5]),
        widths=np.array([1.8, 2.0, 0.4, 0.7, 1.8]), valid=valid)
    jpreds = JPreds(**{k: jnp.asarray(v) for k, v in preds.items()})
    tpreds = TPreds(**{k: t64(v) for k, v in preds.items()})
    return jro, torch_rollout(jro), jpreds, tpreds


def test_collision_probability_fast_matches_jax(risk_inputs):
    jro, tro, jpreds, tpreds = risk_inputs
    want, jt = jprob.collision_probability_fast(jro, jpreds, jkin.VehicleParams())
    got, tt = tprob.collision_probability_fast(tro, tpreds, VehicleParams())
    assert tt == jt == N - 1
    _close(got, want, rtol=RTOL, atol=1e-14)
    want = np.asarray(want)
    assert want.max() > 0.05 and (want[:, 4] == 0).all() and (want[:, 3] > 0).any()


def test_collision_probability_chunks_change_no_bit(risk_inputs, monkeypatch):
    _, tro, _, tpreds = risk_inputs
    whole, _ = tprob.collision_probability_fast(tro, tpreds, VehicleParams())
    monkeypatch.setattr(tprob, "_MAX_CELLS", 9 * 5 * (N - 1) * 7)   # 7 rows a chunk
    chunked, _ = tprob.collision_probability_fast(tro, tpreds, VehicleParams())
    np.testing.assert_array_equal(to_np(chunked), to_np(whole))


def test_collision_probability_on_the_cpu_loads_no_kernel(risk_inputs, monkeypatch):
    _, tro, _, tpreds = risk_inputs

    def no_nvcc():
        raise AssertionError("a CPU call must not build a kernel")
    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(_kernels, "_libraries", {})
    launches = host_count("kernel.q.launches")
    prob, _ = tprob.collision_probability_fast(tro, tpreds, VehicleParams())
    assert float(prob.max()) > 0.05
    assert "risk_quadrature" not in _kernels._libraries
    assert host_count("kernel.q.launches") == launches


@pytest.mark.parametrize("fault", ["f32_predictions", "f32_rollout_field", "int_valid",
                                   "other_device"])
def test_collision_probability_checks_before_any_launch(risk_inputs, fault):
    _, tro, _, tpreds = risk_inputs
    if fault == "f32_predictions":
        tpreds = tpreds._replace(**{f: getattr(tpreds, f).float() for f in (
            "means", "covs", "orientations", "lengths")})
    elif fault == "f32_rollout_field":
        tro = tro._replace(theta_gl=tro.theta_gl.float())
    elif fault == "int_valid":
        tpreds = tpreds._replace(valid=tpreds.valid.to(torch.uint8))
    else:
        tpreds = tpreds._replace(means=tpreds.means.to("meta"))
    with pytest.raises(ValueError if fault == "other_device" else TypeError):
        tprob.collision_probability_fast(tro, tpreds, VehicleParams())


def test_collision_probability_counts_every_cell(risk_inputs):
    _, tro, _, tpreds = risk_inputs
    stacked = type(tro)(*(torch.stack([v, v]) if torch.is_tensor(v) and v.dim() >= 2
                          else v for v in tro))
    preds2 = type(tpreds)(*(torch.stack([v, v]) for v in tpreds))
    m, o = tro.x.shape[0], tpreds.num_obstacles
    before = host_count("risk.quadrature.cells")
    prob, t = tprob.collision_probability_fast(stacked, preds2, VehicleParams())
    assert prob.shape == (2, m, o, t)
    assert tracing.COUNTERS["risk.quadrature.cells"] - before == 2 * m * o * t


def test_inv_mahalanobis_matches_jax(risk_inputs):
    jro, tro, jpreds, tpreds = risk_inputs
    want, jt = jprob.inv_mahalanobis(jro, jpreds)
    got, tt = tprob.inv_mahalanobis(tro, tpreds)
    assert tt == jt
    _close(got, want, rtol=1e-9)


# ------------------------------------------------------------------------ harm


def _harm_inputs(seed=3, n=5000):
    rng = np.random.default_rng(seed)
    dv = rng.uniform(0.0, 30.0, n)
    angle = rng.uniform(-3 * np.pi, 3 * np.pi, n)
    deg = np.pi / 180.0
    edges = np.array([-180, -165, -135, -105, -75, -45, -15, 0, 15, 45, 75, 105,
                      135, 165, 180]) * deg
    angle[:len(edges)] = edges            # the bin edges themselves
    return dv, angle


@pytest.mark.parametrize("variant", [
    dict(ignore_angle=True), dict(sym=True, reduced=True),
    dict(sym=True, reduced=False), dict(sym=False, reduced=True),
    dict(sym=False, reduced=False),
])
@pytest.mark.parametrize("model", ["log_reg_harm", "ref_speed_harm"])
def test_angle_harm_models_match_jax(model, variant):
    dv, angle = _harm_inputs()
    want = getattr(jharm, model)(jnp.asarray(dv), jnp.asarray(angle), **variant)
    got = getattr(tharm, model)(t64(dv), t64(angle), **variant)
    _close(got, want, what=f"{model} {variant}")
    assert len(np.unique(np.round(to_np(got), 6))) > 10


@pytest.mark.parametrize("model", ["gidas_harm", "pedestrian_harm"])
def test_speed_harm_models_match_jax(model):
    dv, _ = _harm_inputs()
    _close(getattr(tharm, model)(t64(dv)), getattr(jharm, model)(jnp.asarray(dv)))


def test_angle_range_and_tables_match_jax():
    _, angle = _harm_inputs()
    angle[:3] = [np.pi, -np.pi, 3 * np.pi]
    _close(tharm.angle_range(t64(angle)), jharm.angle_range(jnp.asarray(angle)),
           rtol=1e-15)
    assert tharm.DEFAULT_HARM_COEFFS == jharm.DEFAULT_HARM_COEFFS
    for kind in ("car", "truck", "bus", "bicycle", "pedestrian", "motorcycle",
                 "taxi", "train", "pillar", "building", "unknown", "other"):
        assert tharm.obstacle_protection(kind) == jharm.obstacle_protection(kind)
        assert tharm.obstacle_mass(kind, 7.3) == jharm.obstacle_mass(kind, 7.3)


def test_obstacle_meta_matches_jax():
    rng = np.random.default_rng(4)
    lengths = np.concatenate([rng.uniform(0.3, 6.0, 40), [0.5, 1.0, 1.4, 2.5 ** 0.5]])
    widths = np.concatenate([rng.uniform(0.3, 2.5, 40), [0.4, 1.0, 1.0, 2.5 ** 0.5]])
    want = jharm.meta_from_footprint(lengths, widths, xp=np, dtype=np.float64)
    got = tharm.meta_from_footprint(t64(lengths), t64(widths))
    _close(got.mass, want.mass, rtol=1e-13)
    np.testing.assert_array_equal(to_np(got.protected), want.protected)
    assert got.protected.dtype == torch.int32

    from frenetix_tpu.io.scenario_factory import make_crosswalk

    obstacles = list(make_crosswalk().obstacles.values())
    jm = jharm.ObstacleMeta.from_obstacles(obstacles, 6, dtype=np.float64)
    tm = tharm.ObstacleMeta.from_obstacles(obstacles, 6, CPU, dtype=torch.float64)
    _close(tm.mass, jm.mass, rtol=1e-15)
    np.testing.assert_array_equal(to_np(tm.protected), np.asarray(jm.protected))
    back = tharm.meta_from_numpy(np.asarray(jm.mass), np.asarray(jm.protected),
                                 device=CPU)
    np.testing.assert_array_equal(to_np(back.mass), np.asarray(jm.mass))
    assert back.protected.dtype == torch.int32


# ----------------------------------------------------------- trajectory risks


@pytest.mark.parametrize("mode_overrides", [
    {}, {"fast_prob_mahalanobis": True},
    {"harm_mode": "ref_speed", "sym_angle": False},
    {"harm_mode": "gidas"},
], ids=["default", "mahalanobis", "ref_speed_asym", "gidas"])
def test_trajectory_risks_match_jax(risk_inputs, mode_overrides):
    jro, tro, jpreds, tpreds = risk_inputs
    lengths, widths = np.asarray(jpreds.lengths), np.asarray(jpreds.widths)
    jmeta = jharm.meta_from_footprint(lengths, widths, xp=np, dtype=np.float64)
    tmeta = tharm.meta_from_numpy(jmeta.mass, jmeta.protected, device=CPU)
    jmodes = {**jrc.DEFAULT_RISK_MODES, **mode_overrides}
    tmodes = {**trc.DEFAULT_RISK_MODES, **mode_overrides}
    want = jrc.trajectory_risks(jro, jpreds, jmeta, 1475.0, modes=jmodes)
    got = trc.trajectory_risks(tro, tpreds, tmeta, 1475.0, modes=tmodes)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), to_np(getattr(got, f))
        assert a.shape == b.shape, f
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-14, err_msg=f)
    assert np.asarray(want.ego_risk).max() > 1e-4
    assert (np.asarray(want.obst_present) == [True, True, True, True, False]).all()
    assert trc.DEFAULT_RISK_MODES == jrc.DEFAULT_RISK_MODES


def test_trajectory_risks_without_obstacles(risk_inputs):
    from frenetix_tpu_torch.ops.costs import empty_predictions

    _, tro, _, _ = risk_inputs
    got = trc.trajectory_risks(tro, empty_predictions(N, torch.float64, CPU),
                               tharm.meta_from_numpy([], [], device=CPU), 1475.0)
    m = tro.x.shape[0]
    assert got.ego_risk.shape == (m,) and got.ego_risk_per_obst.shape == (m, 0)
    assert float(got.ego_risk.abs().sum()) == 0.0


# ------------------------------------------------------------ min_risk cycle


def _wall_predictions(x_wall, n_obstacles=3, horizon=N, max_obstacles=4):
    """A standing wall of boxes across the road at x_wall (host fields)."""
    pd = dict(
        means=np.zeros((max_obstacles, horizon, 2)),
        covs=np.tile(np.eye(2) * 0.5, (max_obstacles, horizon, 1, 1)),
        inv_covs=np.tile(np.eye(2) * 2.0, (max_obstacles, horizon, 1, 1)),
        orientations=np.zeros((max_obstacles, horizon)),
        velocities=np.zeros((max_obstacles, horizon)),
        lengths=np.zeros(max_obstacles), widths=np.zeros(max_obstacles),
        valid=np.zeros((max_obstacles, horizon), bool))
    for k in range(n_obstacles):
        pd["means"][k, :, 0] = x_wall + 0.3 * k
        pd["means"][k, :, 1] = -4.0 + 4.0 * k
        pd["lengths"][k], pd["widths"][k] = 4.5 + 0.2 * k, 4.4
        pd["velocities"][k] = 0.5 * k
        pd["valid"][k] = True
    return pd


@pytest.mark.parametrize("log_risk", [False, True])
def test_cycle_ends_in_min_risk_and_selects_the_jax_index(log_risk):
    from frenetix_tpu.planner.initial_state import CartesianState as JState
    from frenetix_tpu.planner.reactive import ReactivePlanner as JPlanner
    from frenetix_tpu.sim.prediction import to_device as jto_device
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig
    from frenetix_tpu_torch.planner.initial_state import CartesianState as TState
    from frenetix_tpu_torch.planner.reactive import ReactivePlanner as TPlanner
    from frenetix_tpu_torch.sim.prediction import to_device as tto_device
    from frenetix_tpu_torch.utils.config import FrenetixConfig as TConfig

    polyline = np.stack([np.linspace(0.0, 200.0, 101), np.zeros(101)], axis=1)
    state = dict(x=20.0, y=0.1, orientation=0.02, velocity=10.0, acceleration=0.0,
                 steering_angle=0.0, yaw_rate=0.0)
    pd = _wall_predictions(x_wall=28.0)
    plans = []
    for Planner, Config, State, kw in (
            (JPlanner, JConfig, JState, {}),
            (TPlanner, TConfig, TState, {"device": CPU})):
        cfg = Config(dtype="float64")
        cfg.planning.emergency_mode = "min_risk"
        cfg.debug.log_risk = log_risk
        planner = Planner(cfg, **kw)
        planner.set_reference_path(polyline)
        if Planner is JPlanner:
            planner.set_predictions(jto_device(pd, jnp))
        else:
            planner.set_predictions(tto_device(pd, CPU, torch.float64))
        planner.set_obstacles(pd["means"][:, 0], pd["valid"][:, 0])
        planner.set_desired_velocity(10.0)
        x0 = State(**state)
        if Planner is JPlanner:
            x_cl = planner.compute_initial_state(x0)
        else:
            from frenetix_tpu_torch.planner.initial_state import compute_initial_state_np

            x_cl = compute_initial_state_np(planner.ref_np, x0, planner.veh.wheelbase,
                                            False)
        plan = planner.plan(x0, x_cl)
        assert plan is not None and plan.mode == "min_risk"
        assert planner.stats["collisions"] > 0
        plans.append(plan)
    jplan, tplan = plans
    np.testing.assert_array_equal(tplan.sampling_parameters, jplan.sampling_parameters)
    for f in ("x", "y", "theta", "v", "a", "kappa", "s", "d"):
        np.testing.assert_allclose(getattr(tplan, f), getattr(jplan, f), rtol=1e-9,
                                   atol=1e-10, err_msg=f)
    np.testing.assert_allclose(tplan.cost, jplan.cost, rtol=1e-9)
    if log_risk:
        assert jplan.ego_risk > 0.0
        np.testing.assert_allclose([tplan.ego_risk, tplan.obst_risk],
                                   [jplan.ego_risk, jplan.obst_risk], rtol=RTOL)
    else:
        assert tplan.ego_risk is None and jplan.ego_risk is None


def test_log_risk_on_an_optimal_plan_matches_jax():
    """`debug.log_risk` alone: the selected (optimal) trajectory carries the
    risks of the full stack; obstacle metadata handed to the planner is used."""
    from frenetix_tpu_torch.planner.initial_state import (
        CartesianState, compute_initial_state_np,
    )
    from frenetix_tpu_torch.planner.reactive import ReactivePlanner
    from frenetix_tpu_torch.sim.prediction import to_device
    from frenetix_tpu_torch.utils.config import FrenetixConfig

    cfg = FrenetixConfig(dtype="float64")
    cfg.debug.log_risk = True
    planner = ReactivePlanner(cfg, CPU)
    polyline = np.stack([np.linspace(0.0, 200.0, 101), np.zeros(101)], axis=1)
    planner.set_reference_path(polyline)
    pd = _wall_predictions(x_wall=45.0, n_obstacles=1)
    pd["means"][0, :, 1] = 3.0
    preds = to_device(pd, CPU, torch.float64)
    x0 = CartesianState(x=20.0, y=0.0, orientation=0.0, velocity=10.0,
                        acceleration=0.0, steering_angle=0.0, yaw_rate=0.0)
    x_cl = compute_initial_state_np(planner.ref_np, x0, planner.veh.wheelbase, False)
    risks = []
    for meta in (None, tharm.meta_from_numpy(np.full(4, 25000.0), np.ones(4),
                                             device=CPU)):
        planner.set_predictions(preds, meta)
        planner.set_obstacles(pd["means"][:, 0], pd["valid"][:, 0])
        planner.set_desired_velocity(10.0)
        plan = planner.plan(x0, x_cl)
        assert plan.mode == "optimal" and plan.ego_risk is not None
        risks.append((plan.ego_risk, plan.obst_risk))
    assert risks[1][0] > risks[0][0] >= 0.0      # a truck's mass harms the ego more
