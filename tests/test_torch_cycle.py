"""Parity of the port's replanning cycle with the JAX package, float64 on CPU.

`planner.core.evaluate_cycle` of both packages runs on the same numpy
problem (the shapes of `__graft_entry__._synthetic_problem`: R = 868 table
rows, 720 candidates padded to 768, 4 obstacles, a ±4 m corridor) and on its
variants.  best_idx, found, histogram and every mask must be equal; float
fields agree to rtol 1e-9 (absolute floor 1e-10).  Where best_idx differs the
selection is accepted only if the two candidates' costs lie within 4 ulps of
each other: then the pick is a tie decided by round-off in the summation
order, not a different planner decision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frenetix_tpu.ops.costs import COST_TERM_ORDER, PredictionTensors as JPreds
from frenetix_tpu.ops.kinematics import VehicleParams as JVeh
from frenetix_tpu.planner.core import CycleContext as JCtx, evaluate_cycle as jeval
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.planner.core import context_from_numpy, evaluate_cycle as teval
from tests.torch_parity import CPU, assert_fields_match, t64, to_np

torch.set_num_threads(1)

DT = 0.1
N = 30
ULPS = 4


def _problem():
    """Numpy matrix, mask and context fields of the synthetic problem."""
    ref, matrix, mask, preds, _ = graft._synthetic_problem(dtype=np.float64)
    ref = type(ref)(*(np.asarray(f) for f in ref))
    preds = {k: np.asarray(v) for k, v in preds._asdict().items()}
    weights = np.zeros(len(COST_TERM_ORDER))
    for name, w in dict(lateral_jerk=0.2, longitudinal_jerk=0.2, velocity_offset=1.0,
                        distance_to_reference_path=5.0, prediction=0.2).items():
        weights[COST_TERM_ORDER.index(name)] = w
    corridor = np.empty((ref.s.shape[0], 2))
    corridor[:, 0], corridor[:, 1] = -4.0, 4.0
    fields = dict(
        ref=ref, veh=tuple(VehicleParams()), weights=weights, preds=preds,
        obstacle_xy=preds["means"][:, 0], obstacle_valid=preds["valid"][:, 0],
        corridor=corridor, lane_segments=np.zeros((0, 2, 2)),
        lane_valid=np.zeros((0,), bool), x0_orientation=np.asarray(0.27),
        desired_velocity=np.asarray(12.0), desired_avg_velocity=np.asarray(12.0),
    )
    return np.asarray(matrix), np.asarray(mask), fields


def _jax_ctx(f):
    return JCtx(
        ref=type(f["ref"])(*(jnp.asarray(x) for x in f["ref"])), veh=JVeh(*f["veh"]),
        weights=jnp.asarray(f["weights"]),
        preds=JPreds(**{k: jnp.asarray(v) for k, v in f["preds"].items()}),
        **{k: jnp.asarray(f[k]) for k in (
            "obstacle_xy", "obstacle_valid", "corridor", "lane_segments",
            "lane_valid", "x0_orientation", "desired_velocity",
            "desired_avg_velocity")},
    )


def _empty_obstacles(f):
    f = dict(f)
    f["preds"] = {k: v[:0] for k, v in f["preds"].items()}
    f["obstacle_xy"] = f["obstacle_xy"][:0]
    f["obstacle_valid"] = f["obstacle_valid"][:0]
    return f


def _run_both(matrix, mask, fields, **kw):
    kw = {"dt": DT, "n_steps": N, "low_vel_mode": False, **kw}
    jres = jeval(jnp.asarray(matrix), jnp.asarray(mask), _jax_ctx(fields), **kw)
    tres = teval(t64(matrix), torch.as_tensor(np.array(mask)),
                 context_from_numpy(**fields, device=CPU, dtype=torch.float64), **kw)
    return jres, tres


def _assert_same_cycle(jres, tres):
    assert_fields_match(jres.rollout, tres.rollout, what="rollout.")
    assert_fields_match(jres, tres, fields=(
        "cost_terms", "cost", "collides", "boundary_step", "boundary_harm",
        "selectable", "found", "histogram"))
    jb, tb = int(jres.best_idx), int(tres.best_idx)
    if jb != tb:
        cost = to_np(tres.cost)
        gap = abs(cost[jb] - cost[tb])
        assert gap <= ULPS * np.spacing(max(abs(cost[jb]), abs(cost[tb]))), (
            f"best_idx {tb} (port) vs {jb} (JAX) with a cost gap of {gap}: "
            "beyond 4 ulps, so not a round-off tie")


def test_cycle_matches_jax_on_synthetic_problem():
    matrix, mask, fields = _problem()
    assert matrix.shape[0] == 768 and (~mask).any()   # padding rows present
    jres, tres = _run_both(matrix, mask, fields)
    _assert_same_cycle(jres, tres)
    assert bool(tres.found)
    assert to_np(tres.collides).any() and to_np(tres.boundary_step >= 0).any()
    assert bool(to_np(mask)[int(tres.best_idx)])       # never a padding row
    # padding rows count in no histogram slot
    hist_all = to_np(tres.rollout.inf_slots).sum(axis=0)
    assert (to_np(tres.histogram) <= hist_all).all()


def test_cycle_matches_jax_without_obstacles():
    matrix, mask, fields = _problem()
    jres, tres = _run_both(matrix, mask, _empty_obstacles(fields))
    _assert_same_cycle(jres, tres)
    assert not to_np(tres.collides).any()


def test_cycle_matches_jax_out_of_domain_start():
    matrix, mask, fields = _problem()
    matrix = matrix.copy()
    matrix[:, 2] = 1000.0            # s0 far beyond the reference path
    jres, tres = _run_both(matrix, mask, fields)
    _assert_same_cycle(jres, tres)
    assert not bool(tres.found)
    hist = to_np(tres.histogram)
    assert hist[3] == mask.sum() and hist[9] == mask.sum()


def test_cycle_matches_jax_low_velocity_mode():
    from frenetix_tpu.ops.sampling import build_sampling_matrix, pad_matrix

    _, _, fields = _problem()
    matrix = build_sampling_matrix(
        t1_vals=[1.1, 2.0, 3.0], ss1_vals=np.linspace(0.001, 4.0, 9),
        d1_vals=np.linspace(-1.5, 1.5, 9), x0_lon=(40.0, 1.2, 0.1),
        x0_lat=(0.3, 0.05, 0.0))
    matrix, mask = pad_matrix(matrix, 256)
    jres, tres = _run_both(matrix, mask, fields, low_vel_mode=True)
    _assert_same_cycle(jres, tres)
    assert bool(tres.found)


def test_cycle_matches_jax_with_compensated_sum():
    matrix, mask, fields = _problem()
    jres, tres = _run_both(matrix, mask, fields, compensated_sum=True)
    _assert_same_cycle(jres, tres)


def test_ties_break_to_the_first_index():
    """Duplicated rows: [A; A].  Duplicates get bitwise equal costs, and the
    selection is the first copy, as in JAX."""
    matrix, _, fields = _problem()
    half = matrix.shape[0] // 2
    matrix = np.concatenate([matrix[:half], matrix[:half]])
    mask = np.ones(matrix.shape[0], bool)
    jres, tres = _run_both(matrix, mask, fields)
    _assert_same_cycle(jres, tres)
    best = int(tres.best_idx)
    assert best < half
    cost = to_np(tres.cost)
    np.testing.assert_array_equal(cost[:half], cost[half:])
    assert bool(to_np(tres.selectable)[best + half])


def test_context_from_numpy_round_trips():
    _, _, fields = _problem()
    jctx_np = jax.tree.map(np.asarray, _jax_ctx(fields))
    tctx = context_from_numpy(**jctx_np._asdict(), device=CPU, dtype=torch.float64)
    for name in jctx_np._fields:
        a, b = getattr(jctx_np, name), getattr(tctx, name)
        if name == "veh":
            assert tuple(a) == tuple(b)
        elif isinstance(a, tuple):          # RefPathTable, PredictionTensors
            assert a._fields == b._fields
            for x, y in zip(a, b):
                assert to_np(y).dtype == (bool if x.dtype == bool else np.float64)
                np.testing.assert_array_equal(to_np(y), x)
        else:
            np.testing.assert_array_equal(to_np(b), a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_workload_matches_bench(dtype):
    """The port's dense-cycle problem (built without JAX) carries the same
    values as bench.py::build_workload."""
    from bench import build_workload
    from frenetix_tpu_torch.workloads import dense_cycle_problem

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    jm, jmask, jctx, dt, n_steps, n_valid = build_workload(dtype=np_dtype)
    tm, tmask, tctx, tdt, tn, tvalid = dense_cycle_problem(CPU, dtype)
    assert (tdt, tn, tvalid) == (dt, n_steps, n_valid) and tm.shape == (34816, 13)
    np.testing.assert_array_equal(to_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(to_np(tmask), np.asarray(jmask))
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jctx._replace(veh=None)))
    tl = [x for f in tctx._fields if f != "veh"
          for x in (getattr(tctx, f) if isinstance(getattr(tctx, f), tuple)
                    else (getattr(tctx, f),))]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(to_np(b), a.astype(to_np(b).dtype))


# -------------------------------------------------------------------- planner


def _planner_case(case):
    """(x0, x_cl, v_des, stop point, prediction fields) of a planner case on
    a straight 200 m road."""
    from frenetix_tpu_torch.planner.initial_state import CartesianState

    v0 = 0.05 if case == "standstill" else 8.0
    x0 = CartesianState(x=40.0, y=0.3, orientation=0.02, velocity=v0,
                        acceleration=0.0, steering_angle=0.0, yaw_rate=0.0)
    o, t = 1, N
    preds = dict(means=np.zeros((o, t, 2)), covs=np.tile(np.eye(2) * 0.5, (o, t, 1, 1)),
                 orientations=np.zeros((o, t)), velocities=np.zeros((o, t)),
                 lengths=np.array([110.0]), widths=np.array([30.0]),
                 valid=np.zeros((o, t), bool))
    preds["inv_covs"] = np.linalg.inv(preds["covs"])
    if case in ("emergency_stopping", "standstill"):
        # one box over the whole road ahead (and, at standstill, over the
        # ego): every candidate collides, so nothing is selectable
        preds["means"][0, :, 0] = 100.0 if case == "emergency_stopping" else 40.0
        preds["valid"][:] = True
    stop_ahead = 25.0 if case == "stopping_plan" else None
    return x0, v0, stop_ahead, preds


@pytest.mark.parametrize("case", ["optimal", "optimal_default_vehicle",
                                  "stopping_plan", "emergency_stopping",
                                  "standstill"])
def test_reactive_planner_matches_jax(case):
    """The port's ReactivePlanner against the JAX one on the same inputs:
    the regular selection, stopping mode (quintic sampling toward a stop
    point), the emergency stopping selection and the standstill fallback."""
    from frenetix_tpu.ops.costs import PredictionTensors as JaxPreds
    from frenetix_tpu.planner.reactive import ReactivePlanner as JaxPlanner
    from frenetix_tpu.utils.config import load_config as jax_load_config
    from frenetix_tpu_torch.planner.initial_state import compute_initial_state_np
    from frenetix_tpu_torch.planner.reactive import ReactivePlanner
    from frenetix_tpu_torch.sim.prediction import to_device
    from frenetix_tpu_torch.utils.config import load_config

    polyline = np.stack([np.linspace(0.0, 200.0, 201), np.zeros(201)], axis=1)
    x0, v0, stop_ahead, preds = _planner_case(case)
    jcfg, tcfg = jax_load_config(), load_config()
    jcfg.dtype = tcfg.dtype = "float64"
    if stop_ahead is None and case != "optimal_default_vehicle":
        # a_max = 2 lifts the end-velocity grid's floor from 0.001 m/s, the
        # "moving" threshold itself, where a 1-ulp difference in evaluating
        # the polynomial flips the yaw-rate slot of that (infeasible) row
        jcfg.vehicle = jcfg.vehicle._replace(a_max=2.0)
        tcfg.vehicle = tcfg.vehicle._replace(a_max=2.0)
    jp, tp = JaxPlanner(jcfg), ReactivePlanner(tcfg, CPU)
    x_cl = None
    for p in (jp, tp):
        p.set_reference_path(polyline)
        x_cl = compute_initial_state_np(p.ref_np, x0, tcfg.vehicle.wheelbase,
                                        v0 < tcfg.planning.low_vel_mode_threshold)
        p.set_desired_velocity(10.0)
        p.set_obstacles(preds["means"][:, 0], preds["valid"][:, 0])
        if stop_ahead is not None:
            p.set_stop_point(x_cl[0][0] + stop_ahead, 0.0)
    jp.set_predictions(JaxPreds(**{k: jnp.asarray(v) for k, v in preds.items()}))
    tp.set_predictions(to_device(preds, CPU, torch.float64))

    jplan, tplan = jp.plan(x0, x_cl), tp.plan(x0, x_cl)
    expected_mode = {"emergency_stopping": "stopping",
                     "optimal_default_vehicle": "optimal"}.get(case, case)
    assert tplan.mode == jplan.mode == expected_mode
    np.testing.assert_array_equal(tplan.sampling_parameters, jplan.sampling_parameters)
    for f in ("x", "y", "theta", "v", "a", "kappa", "s", "s_dot", "s_ddot",
              "d", "d_dot", "d_ddot"):
        np.testing.assert_allclose(getattr(tplan, f), getattr(jplan, f),
                                   rtol=1e-9, atol=1e-10, err_msg=f)
    np.testing.assert_allclose(tplan.cost, jplan.cost, rtol=1e-9, atol=1e-10)
    th, jh = tp.infeasible_histogram, jp.infeasible_histogram
    if case == "optimal_default_vehicle":
        # At the default a_max the end-velocity grid's floor (0.001 m/s) is
        # the "moving" threshold itself; XLA and PyTorch evaluate the
        # polynomial 1 ulp apart there, which can flip the yaw-rate slot (6)
        # of one already infeasible row.  Everything else stays exact.
        other = np.arange(th.shape[0]) != 6
        np.testing.assert_array_equal(th[other], jh[other])
        assert abs(int(th[6]) - int(jh[6])) <= 1
    else:
        np.testing.assert_array_equal(th, jh)
    assert tp.stats == jp.stats
