"""The curvilinear initial state, the planner's method around it, and the
rollout's infeasibility histogram: the port against the JAX package at
float64 on the CPU, from the same NumPy inputs made from a seed.

- `planner.initial_state.compute_initial_state`, the tensor form, for one
  agent (unbatched tables) and for A = 4 agents with leading agent axes,
  against JAX's function (vmapped over the agents for A = 4), in both
  `low_vel_mode`s, within 1e-10; against the port's NumPy form on the same
  states; its θ, κ, κ' reads are one K1 call on the (A·R, 3) table (the
  card case, one K1 launch, is in test_torch_sim.py, which imports no JAX).
- `ReactivePlanner.compute_initial_state(x0)` against JAX's method, above
  and below the low-velocity threshold.
- `Rollout.histogram` against JAX's property, and with leading agent axes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frenetix_tpu.planner import initial_state as jis
from frenetix_tpu_torch.geometry import frenet as tfr
from frenetix_tpu_torch.planner import initial_state as tis
from frenetix_tpu_torch.workloads import initial_state_problem

from torch_parity import CPU

TOL = 1e-10
WHEELBASE = 2.578
N_AGENTS = 4


def _problem(n_agents, seed):
    """`workloads.initial_state_problem`: agents on rotated copies of one
    S-bend (κ and κ' vary along it), a few metres beside their paths, made
    from a seed: (stacked tables as float64 tensors, CartesianState of (A,)
    tensors, per-agent NumPy tables, per-agent CartesianStates of floats)."""
    return initial_state_problem(n_agents, CPU, torch.float64, seed=seed)


def _jax_tables(ref_np):
    return type(ref_np)(*(jnp.asarray(np.asarray(f)) for f in ref_np))


@pytest.mark.parametrize("low_vel_mode", [False, True], ids=["time", "arclength"])
@pytest.mark.parametrize("n_agents", [1, N_AGENTS])
def test_compute_initial_state_matches_jax(n_agents, low_vel_mode):
    ref, state, refs, rows = _problem(n_agents, seed=7 + n_agents)
    if n_agents == 1:
        jst = jis.CartesianState(*(jnp.asarray(v) for v in rows[0]))
        want = jis.compute_initial_state(_jax_tables(refs[0]), jst, WHEELBASE, low_vel_mode)
        ref = type(ref)(*(f[0] for f in ref))
        state = type(state)(*(v[0] for v in state))
    else:
        jref = type(refs[0])(*(jnp.asarray(np.stack([np.asarray(getattr(r, f)) for r in refs]))
                               for f in refs[0]._fields))
        jst = jis.CartesianState(*(jnp.asarray(np.array(col)) for col in zip(*rows)))
        want = jax.vmap(lambda r, s: jis.compute_initial_state(r, s, WHEELBASE,
                                                               low_vel_mode))(jref, jst)
    got = tis.compute_initial_state(ref, state, WHEELBASE, low_vel_mode)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("low_vel_mode", [False, True], ids=["time", "arclength"])
def test_compute_initial_state_matches_the_numpy_form(low_vel_mode):
    ref, state, refs, rows = _problem(N_AGENTS, seed=3)
    lon, lat = tis.compute_initial_state(ref, state, WHEELBASE, low_vel_mode)
    for a in range(N_AGENTS):
        want = tis.compute_initial_state_np(refs[a], rows[a], WHEELBASE, low_vel_mode)
        np.testing.assert_allclose(lon[a].numpy(), want[0], rtol=0, atol=TOL)
        np.testing.assert_allclose(lat[a].numpy(), want[1], rtol=0, atol=TOL)


def test_compute_initial_state_reads_the_tables_in_one_k1_call(monkeypatch):
    calls = []
    real = tfr.interp_rows

    def counting(table, gidx, lam):
        calls.append((tuple(table.shape), tuple(gidx.shape)))
        return real(table, gidx, lam)

    monkeypatch.setattr(tfr, "interp_rows", counting)
    ref, state, _, _ = _problem(N_AGENTS, seed=11)
    tis.compute_initial_state(ref, state, WHEELBASE, False)
    assert calls == [((N_AGENTS * int(ref.s.shape[-1]), 3), (N_AGENTS,))]


def test_batched_projection_equals_one_agent_at_a_time():
    ref, state, _, _ = _problem(N_AGENTS, seed=5)
    s, d = tfr.cartesian_to_frenet(ref, state.x, state.y)
    for a in range(N_AGENTS):
        one = type(ref)(*(f[a] for f in ref))
        s1, d1 = tfr.cartesian_to_frenet(one, state.x[a], state.y[a])
        assert torch.equal(s[a], s1) and torch.equal(d[a], d1)


@pytest.mark.parametrize("velocity", [0.6, 12.0], ids=["low_velocity", "moving"])
def test_planner_compute_initial_state_matches_jax(velocity):
    from frenetix_tpu.planner.reactive import ReactivePlanner as JPlanner
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig
    from frenetix_tpu_torch.planner.reactive import ReactivePlanner as TPlanner
    from frenetix_tpu_torch.utils.config import FrenetixConfig as TConfig

    x = np.linspace(0.0, 150.0, 300)
    polyline = np.stack([x, 4.0 * np.sin(x / 30.0)], axis=1)
    jp, tp = JPlanner(JConfig(dtype="float64")), TPlanner(TConfig(dtype="float64"), CPU)
    jp.set_reference_path(polyline)
    tp.set_reference_path(polyline)
    x0 = tis.CartesianState(x=40.3, y=4.0 * np.sin(40.3 / 30.0) + 0.7, orientation=0.1,
                            velocity=velocity, acceleration=0.4, steering_angle=0.02,
                            yaw_rate=0.0)
    assert (velocity < tp.config.planning.low_vel_mode_threshold) == (velocity == 0.6)
    want, got = jp.compute_initial_state(x0), tp.compute_initial_state(x0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rollout_histogram_matches_jax():
    from frenetix_tpu.ops.kinematics import Rollout as JRollout
    from frenetix_tpu_torch.ops.kinematics import Rollout as TRollout

    rng = np.random.default_rng(2)
    slots = rng.uniform(size=(N_AGENTS, 64, 11)) < 0.3
    blank = {f: None for f in TRollout._fields}
    got = TRollout(**dict(blank, inf_slots=torch.as_tensor(slots))).histogram
    assert tuple(got.shape) == (N_AGENTS, 11)
    for a in range(N_AGENTS):
        want = JRollout(**dict(blank, inf_slots=jnp.asarray(slots[a]))).histogram
        np.testing.assert_array_equal(got[a].numpy(), np.asarray(want))
        one = TRollout(**dict(blank, inf_slots=torch.as_tensor(slots[a]))).histogram
        np.testing.assert_array_equal(one.numpy(), np.asarray(want))
