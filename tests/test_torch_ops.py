"""Parity of the PyTorch port's ops with the JAX package, in float64 on CPU.

Each test feeds the same numpy inputs, made from a seed, to a JAX function
and to its counterpart in `frenetix_tpu_torch`.  Tolerances: polynomials
1e-12; the K1 plain twin vs the Pallas kernel (interpret mode) 1e-6 in
float32; the table lookup 1e-12; rollout, cost and total fields rtol 1e-9
with an absolute floor of 1e-10 (`tests/torch_parity.py`); masks, histogram
slots and collision results exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frenetix_tpu.geometry import frenet as jfr
from frenetix_tpu.geometry.corridor import strip_corridor
from frenetix_tpu.ops import collision as jcoll
from frenetix_tpu.ops import costs as jcosts
from frenetix_tpu.ops import kinematics as jkin
from frenetix_tpu.ops import polynomials as jpoly
from frenetix_tpu.ops.sampling import build_sampling_matrix, linspace_samples, time_samples
from frenetix_tpu_torch.geometry import frenet as tfr
from frenetix_tpu_torch.ops import collision as tcoll
from frenetix_tpu_torch.ops import costs as tcosts
from frenetix_tpu_torch.ops import kinematics as tkin
from frenetix_tpu_torch.ops import polynomials as tpoly
from frenetix_tpu_torch.ops import table_interp

from tests.torch_parity import (
    assert_fields_match, curved_ref_np, host_count, ref_to_torch, t64, to_np, torch_rollout,
)

torch.set_num_threads(1)

DT = 0.1
N = 30


# ---------------------------------------------------------------- polynomials


def _poly_inputs(seed=3, m=64):
    rng = np.random.default_rng(seed)
    return dict(
        xs=rng.uniform(0, 50, m), vxs=rng.uniform(0, 20, m), axs=rng.uniform(-2, 2, m),
        xe=rng.uniform(50, 90, m), vxe=rng.uniform(0, 20, m), axe=rng.uniform(-1, 1, m),
        T=rng.uniform(0.5, 3.0, m), tau=rng.uniform(0, 3.0, (m, 31)),
    )


@pytest.mark.parametrize("kind", ["quartic", "quintic"])
def test_polynomials_match_jax(kind):
    p = _poly_inputs()
    if kind == "quartic":
        args = (p["xs"], p["vxs"], p["axs"], p["vxe"], p["T"])
        cj, ct = jpoly.quartic_coeffs(*args), tpoly.quartic_coeffs(*map(t64, args))
    else:
        args = (p["xs"], p["vxs"], p["axs"], p["xe"], p["vxe"], p["axe"], p["T"])
        cj, ct = jpoly.quintic_coeffs(*args), tpoly.quintic_coeffs(*map(t64, args))
    np.testing.assert_allclose(to_np(ct), to_np(cj), rtol=1e-12, atol=1e-12)
    tau = p["tau"]
    for name in ("poly_position", "poly_velocity", "poly_acceleration", "poly_jerk"):
        np.testing.assert_allclose(
            to_np(getattr(tpoly, name)(ct, t64(tau))),
            to_np(getattr(jpoly, name)(cj, jnp.asarray(tau))),
            rtol=1e-12, atol=1e-12, err_msg=name,
        )
    np.testing.assert_allclose(
        to_np(tpoly.squared_jerk_integral(ct, DT)),
        to_np(jpoly.squared_jerk_integral(cj, DT)), rtol=1e-12, atol=1e-12,
    )


# ---------------------------------------------------------------- K1 + lookup


def test_plain_twin_matches_pallas_kernel():
    """interp_rows on CPU tensors (the plain twin) against the Pallas kernel
    run through the Pallas interpreter, float32, as tests/test_geometry.py
    runs it.  Also pins that the CPU path launches no kernel."""
    from frenetix_tpu.ops.pallas_interp import interp_tables_pallas

    rng = np.random.default_rng(7)
    w, c, p = 96, 7, 300
    table = rng.normal(size=(w, c)).astype(np.float32)
    idx = rng.integers(0, w - 1, size=p).astype(np.int32)
    lam = rng.uniform(0, 1, size=p).astype(np.float32)

    want = np.asarray(interp_tables_pallas(table, idx, lam, block=128,
                                           interpret=True))          # (P, C)
    before = host_count("kernel.k1.launches")
    got = table_interp.interp_rows(torch.as_tensor(table), torch.as_tensor(idx),
                                   torch.as_tensor(lam))              # (C, P)
    assert host_count("kernel.k1.launches") == before
    assert got.shape == (c, p) and got.is_contiguous()
    np.testing.assert_allclose(to_np(got).T, want, atol=1e-6)


def test_interp_rows_rejects_non_cpu_non_cuda_tensors():
    """A tensor off the CPU never reaches the plain twin: the wrapper launches
    the kernel or raises."""
    table = torch.zeros((4, 3), device="meta")
    gidx = torch.zeros((5,), dtype=torch.int32, device="meta")
    lam = torch.zeros((5,), device="meta")
    with pytest.raises(ValueError):
        table_interp.interp_rows(table, gidx, lam)


def _lookup_queries(ref, seed=11, n=240):
    """s queries: inside the window, inside the domain but outside the
    window, and outside the domain on both ends."""
    rng = np.random.default_rng(seed)
    length = float(ref.s[-1])
    return np.concatenate([
        rng.uniform(30.0, 150.0, n),             # inside the window
        rng.uniform(length - 20.0, length, 20),  # in domain, beyond the window
        rng.uniform(-5.0, -0.01, 10),            # before the path
        rng.uniform(length + 0.01, length + 9.0, 10),
    ]).reshape(-1, 10)


@pytest.mark.parametrize("window", [768, None])
def test_interp_ref_tables_matches_jax(window):
    """Window branch (R = 868 > W = 768, anchored at 40 m) incl. queries
    outside the window and the domain, whose unclipped λ extrapolates; and
    the no-window branch.  The corridor rides along as extra columns."""
    ref = curved_ref_np()
    assert ref.s.shape[0] > 768
    extra = np.random.default_rng(5).normal(size=(ref.s.shape[0], 2))
    s = _lookup_queries(ref)
    anchor = 40.0
    kw_j = dict(window_rows=window, window_anchor=jnp.asarray(anchor) if window else None)
    kw_t = dict(window_rows=window, window_anchor=t64(anchor) if window else None)
    want = jfr.interp_ref_tables(ref, jnp.asarray(s), extra_tables=jnp.asarray(extra),
                                 **kw_j)
    got = tfr.interp_ref_tables(ref_to_torch(ref), t64(s), extra_tables=t64(extra),
                                **kw_t)
    if window:
        in_dom = to_np(got["in_domain"])
        assert in_dom.any() and (~in_dom).any()
    for key in ("alpha", "theta_lerp", "k_r", "k_r_d", "x", "y", "lam"):
        np.testing.assert_allclose(to_np(got[key]), to_np(want[key]),
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    for a, b in zip(got["extras"], want["extras"]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(to_np(got["idx"]), to_np(want["idx"]))
    np.testing.assert_array_equal(to_np(got["in_domain"]), to_np(want["in_domain"]))


def test_no_window_branch_on_short_table():
    """R <= W: the window is skipped even when asked for."""
    ref = curved_ref_np(n_points=200, radius=40.0)
    assert ref.s.shape[0] <= 768
    s = np.linspace(-1.0, float(ref.s[-1]) + 1.0, 90).reshape(9, 10)
    want = jfr.interp_ref_tables(ref, jnp.asarray(s), window_rows=768,
                                 window_anchor=jnp.asarray(3.0))
    got = tfr.interp_ref_tables(ref_to_torch(ref), t64(s), window_rows=768,
                                window_anchor=t64(3.0))
    for key in ("alpha", "k_r", "k_r_d", "x", "y"):
        np.testing.assert_allclose(to_np(got[key]), to_np(want[key]),
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    np.testing.assert_array_equal(to_np(got["in_domain"]), to_np(want["in_domain"]))


def test_frenet_conversions_match_jax():
    ref = curved_ref_np()
    rng = np.random.default_rng(2)
    s = rng.uniform(5.0, 200.0, 40)
    d = rng.uniform(-3.0, 3.0, 40)
    xj, yj, okj = jfr.frenet_to_cartesian(ref, jnp.asarray(s), jnp.asarray(d))
    xt, yt, okt = tfr.frenet_to_cartesian(ref_to_torch(ref), t64(s), t64(d))
    np.testing.assert_allclose(to_np(xt), to_np(xj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(yt), to_np(yj), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(to_np(okt), to_np(okj))
    sj, dj = jfr.cartesian_to_frenet(ref, xj, yj)
    st, dt_ = tfr.cartesian_to_frenet(ref_to_torch(ref), xt, yt)
    np.testing.assert_allclose(to_np(st), to_np(sj), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(to_np(dt_), to_np(dj), rtol=1e-12, atol=1e-10)
    idx, lam, _ = tfr.segment_index(ref_to_torch(ref).s, t64(s))
    np.testing.assert_allclose(
        to_np(tfr.interp_angle_table(ref_to_torch(ref).theta, idx, lam)),
        to_np(jfr.interp_angle_table(jnp.asarray(ref.theta), jnp.asarray(to_np(idx)),
                                     jnp.asarray(to_np(lam)))),
        rtol=1e-12, atol=1e-12,
    )


def test_rounding_and_wrap_pinned():
    """Half-to-even rounding (traj_len, round(yaw_rate, 5)) and the sign of
    fmod in the orientation wrap agree with JAX."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4999999, 12.5])
    np.testing.assert_array_equal(to_np(torch.round(t64(x))), np.asarray(jnp.round(x)))
    th = np.array([0.0, 3.0, 7.0, -7.0, 13.0, -13.0, 6.283185307179586])
    np.testing.assert_array_equal(to_np(tfr.wrap_valid_orientation(t64(th))),
                                  np.asarray(jfr.wrap_valid_orientation(jnp.asarray(th))))


# -------------------------------------------------------------------- rollout


def _matrix(kind):
    """Sampling matrices of the four rollout regimes."""
    level = 1
    if kind == "standstill":
        # a vehicle at rest, and one braking to a halt before the horizon:
        # standstill steps carry θ forward (from x0 or the last moving step)
        m1 = build_sampling_matrix(t1_vals=[1.0, 3.0], ss1_vals=[0.0],
                                   d1_vals=[0.0, 0.5], x0_lon=(35.0, 0.0, 0.0),
                                   x0_lat=(0.2, 0.0, 0.0))
        m2 = build_sampling_matrix(t1_vals=[1.0, 2.0], ss1_vals=[0.0, 0.5],
                                   d1_vals=[-0.5, 0.3], x0_lon=(35.0, 3.0, -1.0),
                                   x0_lat=(0.2, 0.1, 0.0))
        return np.concatenate([m1, m2])
    v0 = 1.2 if kind == "low_vel" else 10.0
    x0_lon = (35.0, v0, 0.2)
    x0_lat = (0.4, 0.05, 0.01)
    t1 = np.unique(np.concatenate([time_samples(1.1, 3.0, DT, level), [N * DT]]))
    if kind == "quintic_lon":
        s1 = linspace_samples(45.0, 70.0, level)   # end positions
        return build_sampling_matrix(t1_vals=t1, ss1_vals=s1,
                                     d1_vals=linspace_samples(-1.0, 1.0, level),
                                     x0_lon=x0_lon, x0_lat=x0_lat)
    ss1 = np.union1d(linspace_samples(max(v0 - 5, 0.001), v0 + 5, level), [v0])
    d1 = np.union1d(linspace_samples(-3, 3, level), [x0_lat[0]])
    return build_sampling_matrix(t1_vals=t1, ss1_vals=ss1, d1_vals=d1,
                                 x0_lon=x0_lon, x0_lat=x0_lat)


_STATIC = ("dt", "n_steps", "low_vel_mode", "quintic_lon", "table_window")


def _rollouts(kind, window=768):
    ref = curved_ref_np()
    corridor = strip_corridor(ref, 3.5)
    base = kind.removesuffix("_n51")
    matrix = _matrix(base)
    kw = dict(dt=DT, n_steps=50 if kind.endswith("_n51") else N,
              low_vel_mode=base == "low_vel", x0_orientation=0.35,
              quintic_lon=base == "quintic_lon", table_window=window)
    jro = jax.jit(jkin.rollout_candidates, static_argnames=_STATIC)(
        jnp.asarray(matrix), ref, jkin.VehicleParams(),
        extra_ref_tables=jnp.asarray(corridor), **kw)
    tro = tkin.rollout_candidates(t64(matrix), ref_to_torch(ref), tkin.VehicleParams(),
                                  extra_ref_tables=t64(corridor), **kw)
    return jro, tro


def _batched_rollouts(n_agents=3, window=768):
    """A (A, M, 13) stack against A tables of one length R = 868 (the arc
    moved and turned per agent, so every agent's window lies elsewhere):
    the JAX function vmapped over the agents against the port's one
    batched call."""
    refs, corridors, matrices = [], [], []
    for a in range(n_agents):
        ref = curved_ref_np()
        turn = 0.3 * a
        rot = np.array([[np.cos(turn), -np.sin(turn)], [np.sin(turn), np.cos(turn)]])
        ref = ref._replace(xy=ref.xy @ rot.T + np.array([10.0 * a, -4.0 * a]),
                           theta=ref.theta + turn)
        refs.append(ref)
        corridors.append(strip_corridor(ref, 3.0 + 0.5 * a))
        matrix = _matrix("normal")
        matrix[:, 2] += 20.0 * a          # s0: the window anchor moves along
        matrices.append(matrix)
    ref = type(refs[0])(*(np.stack(f) for f in zip(*refs)))
    corridor, matrix = np.stack(corridors), np.stack(matrices)
    x0 = np.array([0.35 + 0.3 * a for a in range(n_agents)])
    kw = dict(dt=DT, n_steps=N, low_vel_mode=False, quintic_lon=False,
              table_window=window)

    def one(m, r, c, th):
        return jkin.rollout_candidates(m, r, jkin.VehicleParams(), x0_orientation=th,
                                       extra_ref_tables=c, **kw)

    jro = jax.jit(jax.vmap(one))(jnp.asarray(matrix), ref, jnp.asarray(corridor),
                                 jnp.asarray(x0))
    tro = tkin.rollout_candidates(t64(matrix), ref_to_torch(ref), tkin.VehicleParams(),
                                  x0_orientation=t64(x0), extra_ref_tables=t64(corridor),
                                  **kw)
    return jro, tro


@pytest.mark.parametrize("kind", ["normal", "low_vel", "quintic_lon", "standstill",
                                  "normal_n51", "standstill_n51", "batched"])
def test_rollout_matches_jax(kind):
    jro, tro = _batched_rollouts() if kind == "batched" else _rollouts(kind)
    assert_fields_match(jro, tro, what=f"{kind}: ")
    slots = to_np(tro.inf_slots)
    if kind in ("normal", "normal_n51", "batched"):
        assert slots[..., 0].any() and (~slots[..., 0]).any()
    if kind.startswith("standstill"):
        moving = to_np(tro.s_vel) > 0.001
        assert (~moving).any() and moving.any()
    if kind == "batched":
        # the agents' windows and headings differ, so their rows do too
        x = to_np(tro.x)
        assert not np.allclose(x[0], x[1])


def test_carry_forward_matches_sequential_loop():
    """The cummax/gather carry equals the plain sequential carry."""
    rng = np.random.default_rng(4)
    active = rng.uniform(size=(50, 31)) < 0.4
    vals = rng.normal(size=(50, 31))
    init = rng.normal(size=50)
    got = to_np(tkin._carry_forward_theta(torch.as_tensor(active), t64(vals), t64(init)))
    want = np.empty_like(vals)
    for i in range(50):
        cur = init[i]
        for j in range(31):
            if active[i, j]:
                cur = vals[i, j]
            want[i, j] = cur
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- costs


def _cost_inputs(seed=9):
    rng = np.random.default_rng(seed)
    o, t = 3, 30
    means = np.cumsum(rng.normal(0.8, 0.3, size=(o, t, 2)), axis=1) + np.array([45.0, 8.0])
    covs = np.tile(np.eye(2) * 0.5, (o, t, 1, 1)) + rng.uniform(0, 0.1, (o, t, 1, 1)) * np.eye(2)
    valid = np.ones((o, t), bool)
    valid[1, 20:] = False
    valid[2] = False
    preds = dict(means=means, inv_covs=np.linalg.inv(covs), covs=covs,
                 orientations=rng.uniform(-0.3, 0.3, (o, t)),
                 velocities=rng.uniform(5, 10, (o, t)),
                 lengths=np.array([4.5, 4.8, 2.0]), widths=np.array([1.8, 2.0, 1.0]),
                 valid=valid)
    lane = np.stack([np.stack([np.linspace(0, 200, 41)[:-1], np.zeros(40)], 1),
                     np.stack([np.linspace(0, 200, 41)[1:], np.zeros(40)], 1)], axis=1)
    lane = lane + rng.normal(0, 0.5, lane.shape)
    lane_valid = rng.uniform(size=40) < 0.8
    return dict(preds=preds, obstacle_xy=means[:, 0], obstacle_valid=np.array([True, True, False]),
                lane_segments=lane, lane_valid=lane_valid, desired_velocity=11.0,
                desired_avg_velocity=9.5)


@pytest.fixture(scope="module")
def cost_pair():
    jro, _ = _rollouts("normal")
    ci = _cost_inputs()
    jpreds = jcosts.PredictionTensors(**{k: jnp.asarray(v) for k, v in ci["preds"].items()})
    tpreds = tcosts.PredictionTensors(**{k: t64(v) for k, v in ci["preds"].items()})
    kw = dict(dt=DT, desired_velocity=ci["desired_velocity"],
              desired_avg_velocity=ci["desired_avg_velocity"])
    jt = jcosts.compute_cost_terms(
        jro, preds=jpreds, obstacle_xy=jnp.asarray(ci["obstacle_xy"]),
        obstacle_valid=jnp.asarray(ci["obstacle_valid"]),
        lane_segments=jnp.asarray(ci["lane_segments"]),
        lane_valid=jnp.asarray(ci["lane_valid"]), **kw)
    tro = torch_rollout(jro)
    tt = tcosts.compute_cost_terms(
        tro, preds=tpreds, obstacle_xy=t64(ci["obstacle_xy"]),
        obstacle_valid=t64(ci["obstacle_valid"]),
        lane_segments=t64(ci["lane_segments"]), lane_valid=t64(ci["lane_valid"]),
        responsibility_cost=t64(np.zeros(tro.x.shape[0])), **kw)
    return jro, tro, jpreds, tpreds, to_np(jt), to_np(tt)


@pytest.mark.parametrize("term", jcosts.COST_TERM_ORDER)
def test_cost_term_matches_jax(cost_pair, term):
    *_, jt, tt = cost_pair
    assert tcosts.COST_TERM_ORDER == jcosts.COST_TERM_ORDER
    k = jcosts.COST_TERM_ORDER.index(term)
    np.testing.assert_allclose(tt[:, k], jt[:, k], rtol=1e-9, atol=1e-10, err_msg=term)
    if term in ("prediction", "lane_center_offset", "distance_to_obstacles",
                "velocity_offset", "lateral_jerk"):
        assert np.any(jt[:, k] != 0.0), term


def test_simpson_even_and_odd_counts_match_jax():
    rng = np.random.default_rng(1)
    for n in (2, 3, 30, 31):
        y = rng.normal(size=(7, n))
        np.testing.assert_allclose(to_np(tcosts.simpson_uniform(t64(y), DT)),
                                   to_np(jcosts.simpson_uniform(jnp.asarray(y), DT)),
                                   rtol=1e-12, atol=1e-14, err_msg=str(n))


@pytest.mark.parametrize("compensated", [False, True])
def test_weighted_total_matches_jax(cost_pair, compensated):
    *_, jt, tt = cost_pair
    w = np.random.default_rng(6).uniform(0, 2, jt.shape[1])
    np.testing.assert_allclose(
        to_np(tcosts.weighted_total(t64(jt), t64(w), compensated=compensated)),
        to_np(jcosts.weighted_total(jnp.asarray(jt), jnp.asarray(w),
                                    compensated=compensated)),
        rtol=1e-9, atol=1e-10,
    )


def test_empty_predictions_give_zero_terms():
    _, tro = _rollouts("normal")
    preds = tcosts.empty_predictions(N, torch.float64)
    assert preds.num_obstacles == 0 and preds.horizon == N
    assert not tcoll.prediction_collisions(tro, preds, tkin.VehicleParams()).any()
    assert torch.all(tcosts.prediction_costs(tro, preds) == 0)


# ------------------------------------------------------------------ collision


def test_prediction_collisions_match_jax(cost_pair):
    jro, tro, jpreds, tpreds, *_ = cost_pair
    # obstacles on two candidates' own paths late in the horizon (where the
    # candidates have spread apart), so both outcomes occur
    x, y = np.asarray(jro.x), np.asarray(jro.y)
    means = np.array(np.asarray(jpreds.means))
    means[0, :, 0], means[0, :, 1] = x[7, 1:], y[7, 1:]
    means[1, :, 0], means[1, :, 1] = x[-3, 1:] + 1.0, y[-3, 1:] - 0.5
    valid = np.array(np.asarray(jpreds.valid))
    valid[:2, :22] = False
    jp = jpreds._replace(means=jnp.asarray(means), valid=jnp.asarray(valid))
    tp = tpreds._replace(means=t64(means), valid=torch.as_tensor(valid))
    want = np.asarray(jcoll.prediction_collisions(jro, jp, jkin.VehicleParams()))
    got = to_np(tcoll.prediction_collisions(tro, tp, tkin.VehicleParams()))
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(got, want)


def test_road_departure_corridor_matches_jax(cost_pair):
    jro, tro, *_ = cost_pair
    fj, vj = jcoll.road_departure_corridor(jro, jkin.VehicleParams())
    ft, vt = tcoll.road_departure_corridor(tro, tkin.VehicleParams())
    assert (np.asarray(fj) >= 0).any() and (np.asarray(fj) < 0).any()
    np.testing.assert_array_equal(to_np(ft), np.asarray(fj))
    np.testing.assert_array_equal(to_np(vt), np.asarray(vj))


def test_obb_overlap_matches_jax():
    rng = np.random.default_rng(8)
    n = 500
    ca, cb = rng.uniform(-4, 4, (n, 2)), rng.uniform(-4, 4, (n, 2))
    ta, tb = rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n)
    ha, hb = rng.uniform(0.5, 2.5, (n, 2)), rng.uniform(0.5, 2.5, (n, 2))
    want = np.asarray(jcoll.obb_overlap(*map(jnp.asarray, (ca, ta, ha, cb, tb, hb))))
    got = to_np(tcoll.obb_overlap(*map(t64, (ca, ta, ha, cb, tb, hb))))
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(got, want)


def _strip_quads(half_width=2.6, step=12):
    """The per-segment quads of a strip of `half_width` around the curved
    reference path, every `step`-th vertex; alternate windings."""
    ref = curved_ref_np()
    xy, th = np.asarray(ref.xy)[::step], np.asarray(ref.theta)[::step]
    nrm = np.stack([-np.sin(th), np.cos(th)], axis=1) * half_width
    left, right = xy + nrm, xy - nrm
    quads = np.stack([left[:-1], left[1:], right[1:], right[:-1]], axis=1)
    quads[::2] = quads[::2, ::-1]
    return quads


def test_points_in_quads_matches_jax():
    rng = np.random.default_rng(12)
    quads = _strip_quads()
    ref = curved_ref_np()
    pts = (np.asarray(ref.xy)[rng.integers(0, len(ref.xy), (3, 80))]
           + rng.normal(0.0, 2.5, (3, 80, 2)))
    pts[0, :4] = quads[5, :4]             # the corners themselves lie on edges
    want = np.asarray(jcoll.points_in_quads(jnp.asarray(pts), jnp.asarray(quads)))
    got = to_np(tcoll.points_in_quads(t64(pts), t64(quads)))
    assert got.shape == (3, 80) and want.any() and (~want).any() and want[0, :4].all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_quads", [0, None], ids=["no_quads", "strip"])
def test_road_boundary_departure_matches_jax(cost_pair, n_quads):
    jro, tro, *_ = cost_pair
    quads = _strip_quads() if n_quads is None else np.zeros((0, 4, 2))
    fj, vj = jcoll.road_boundary_departure(jro, jkin.VehicleParams(), jnp.asarray(quads))
    ft, vt = tcoll.road_boundary_departure(tro, tkin.VehicleParams(), t64(quads))
    fj, vj = np.asarray(fj), np.asarray(vj)
    assert ft.dtype == torch.int32 and vt.dtype == torch.float64
    if n_quads is None:
        assert (fj >= 0).any() and (fj < 0).any()
    else:
        assert (fj == -1).all() and (vj == 0.0).all()
    np.testing.assert_array_equal(to_np(ft), fj)
    np.testing.assert_allclose(to_np(vt), vj, rtol=0.0, atol=1e-12)
    # leading agent axes: two agents stacked give each its own answer
    stacked = type(tro)(*(torch.stack([f, f]) if isinstance(f, torch.Tensor) else f
                          for f in tro))
    fs, vs = tcoll.road_boundary_departure(stacked, tkin.VehicleParams(), t64(quads))
    assert fs.shape == (2,) + fj.shape
    np.testing.assert_array_equal(to_np(fs[1]), fj)
    np.testing.assert_allclose(to_np(vs[0]), vj, rtol=0.0, atol=1e-12)


def test_planned_trajectory_helpers_match_jax():
    from frenetix_tpu.planner.reactive import PlannedTrajectory as JPlanned
    from frenetix_tpu_torch.planner.reactive import PlannedTrajectory as TPlanned

    rng = np.random.default_rng(13)
    fields = {f: rng.normal(size=N + 1) for f in (
        "x", "y", "theta", "v", "a", "kappa", "s", "s_dot", "s_ddot", "d", "d_dot",
        "d_ddot")}
    fields.update(cost=1.5, sampling_parameters=rng.normal(size=13))
    j, t = JPlanned(**fields), TPlanned(**fields)
    assert t.compute_steering(2.97) is t
    j.compute_steering(2.97)
    np.testing.assert_array_equal(t.steering_angle, j.steering_angle)
    for yr0 in (0.0, 0.31):
        np.testing.assert_array_equal(t.yaw_rate(DT, yr0), j.yaw_rate(DT, yr0))
