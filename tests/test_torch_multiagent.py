"""The port's agent axis against the JAX package, float64 on the CPU.

- `_pad_table`, `stack_cycle_contexts`: equal arrays (exact; they only move
  and extrapolate numbers with the same NumPy expressions).
- `batched_full_cycle` against JAX `batched_full_cycle` on the JAX tests' own
  stacked problem (`bench_scaling.build_stacked_problem(8, float64,
  n_steps=30, spread=12.0)`): per agent equal `found`, equal `best` or a tie
  whose two costs lie within 4 ulps, selected rows within rtol 1e-9
  (absolute floor 1e-10).
- The port's batched cycle against its own sequential `evaluate_cycle`, on
  per-agent tables of different R: equal `best` and bitwise equal costs.
- Ties resolve to the lowest index per agent; agents that ride along with
  all-False masks come back `found == False` and change nothing for the rest.
- `agent_pose_predictions`, `agent_plan_predictions`, `concat_obstacles`:
  rtol 1e-12 against JAX.
- K1's wrapper on a stacked (A·R, C) table against the plain twin per agent:
  bitwise equal; a per-agent row index stays in [0, R-2].
- Multi-agent `Simulation` on `make_highway(n_steps=80)` with
  `start_multiagent`, sequential and batched, against the JAX `Simulation`:
  equal statuses and step counts, positions and velocities within 1e-9.
- Agent selection and the farthest-obstacle eviction against JAX.

Where the JAX functions would reach the Pallas kernel on a TPU they run its
plain route here, as the JAX package's own tests do on the CPU.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch import workloads
from frenetix_tpu_torch.geometry import frenet as tfr
from frenetix_tpu_torch.ops import table_interp
from frenetix_tpu_torch.ops.costs import PredictionTensors as TPreds
from frenetix_tpu_torch.parallel import mesh as tmesh
from frenetix_tpu_torch.planner.core import (
    CycleContext as TCtx, context_from_numpy, evaluate_cycle as teval,
)
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig

from tests.torch_parity import ATOL, CPU, RTOL, host_count, t64, to_np

torch.set_num_threads(1)

ULPS = 4
A = 8
DT, N = 0.1, 30


# ------------------------------------------------------------------ stacking


@pytest.mark.parametrize("shape,r_max,is_s", [
    ((40,), 55, True), ((40,), 55, False), ((40, 2), 55, False),
    ((40,), 40, True), ((40, 2), 30, False),
])
def test_pad_table_matches_jax(shape, r_max, is_s):
    from frenetix_tpu.parallel.mesh import _pad_table as jpad

    rng = np.random.default_rng(3)
    a = np.cumsum(rng.uniform(0.2, 0.3, shape), axis=0)
    want = jpad(a, r_max, is_pathlength=is_s)
    got = tmesh._pad_table(a, r_max, is_pathlength=is_s)
    np.testing.assert_array_equal(got, want)
    got_t = tmesh._pad_table(torch.as_tensor(a), r_max, is_pathlength=is_s)
    np.testing.assert_array_equal(got_t, want)
    if is_s and r_max > shape[0]:
        # the extrapolated path length keeps the last step
        np.testing.assert_allclose(np.diff(got)[shape[0] - 1:], a[-1] - a[-2],
                                   rtol=1e-12)


def _ragged_numpy_contexts(n_agents=3):
    """Per-agent context fields with different R, S and O (NumPy leaves)."""
    _, _, agents = workloads._stacked_cycle_numpy(n_agents, np.float64, N, 256,
                                                  12.0, ragged=True)
    rng = np.random.default_rng(11)
    for i, f in enumerate(agents):
        s = 2 + i
        f["lane_segments"] = rng.normal(size=(s, 2, 2))
        f["lane_valid"] = np.ones(s, bool)
        o = 4 - (i % 2)
        f["preds"] = {k: v[:o] for k, v in f["preds"].items()}
        f["obstacle_xy"] = f["obstacle_xy"][:o]
        f["obstacle_valid"] = f["obstacle_valid"][:o]
        f["x0_orientation"] = np.asarray(0.1 * i)
    return agents


def test_stack_cycle_contexts_matches_jax():
    from frenetix_tpu.ops.costs import PredictionTensors as JPreds
    from frenetix_tpu.parallel.mesh import stack_cycle_contexts as jstack
    from frenetix_tpu.planner.core import CycleContext as JCtx

    agents = _ragged_numpy_contexts()
    assert len({f["ref"].s.shape[0] for f in agents}) > 1
    jctx = jstack([JCtx(**{**f, "preds": JPreds(**f["preds"])}) for f in agents])
    tctx = tmesh.stack_cycle_contexts(
        [TCtx(**{**f, "preds": TPreds(**f["preds"])}) for f in agents])
    for name in ("obstacle_xy", "obstacle_valid", "corridor", "lane_segments",
                 "lane_valid", "x0_orientation", "desired_velocity",
                 "desired_avg_velocity", "weights"):
        np.testing.assert_array_equal(to_np(getattr(tctx, name)),
                                      to_np(getattr(jctx, name)), err_msg=name)
    for name in jctx.ref._fields:
        np.testing.assert_array_equal(to_np(getattr(tctx.ref, name)),
                                      to_np(getattr(jctx.ref, name)), err_msg=name)
    for name in jctx.preds._fields:
        np.testing.assert_array_equal(to_np(getattr(tctx.preds, name)),
                                      to_np(getattr(jctx.preds, name)), err_msg=name)
    assert tuple(tctx.veh) == tuple(jctx.veh)


# -------------------------------------------------------------- batched cycle


@pytest.fixture(scope="module")
def jax_problem():
    """The JAX tests' stacked problem, its JAX batched result, and the same
    problem as the port's stacked context."""
    import bench_scaling
    from frenetix_tpu.parallel.mesh import batched_full_cycle as jbatched

    matrices, masks, jctx = bench_scaling.build_stacked_problem(
        A, dtype=np.float64, n_steps=N, spread=12.0)
    jout = jbatched(dt=DT, n_steps=N)(matrices, masks, jctx)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    leaves = {f: getattr(jctx, f) for f in jctx._fields}
    leaves["ref"] = type(jctx.ref)(*(np.asarray(x) for x in jctx.ref))
    leaves["preds"] = {k: np.asarray(v) for k, v in jctx.preds._asdict().items()}
    tctx = context_from_numpy(**leaves, device=CPU, dtype=torch.float64)
    return t64(matrices), torch.as_tensor(np.array(masks)), tctx, jout


def _same_or_tie(best_a, best_b, cost_row):
    if best_a == best_b:
        return True
    ca, cb = cost_row[best_a], cost_row[best_b]
    return abs(ca - cb) <= ULPS * np.spacing(max(abs(ca), abs(cb)))


def test_batched_full_cycle_matches_jax(jax_problem):
    matrices, masks, tctx, jout = jax_problem
    before = host_count("kernel.k1.launches")
    tout = tmesh.batched_full_cycle(dt=DT, n_steps=N)(matrices, masks, tctx)
    assert host_count("kernel.k1.launches") == before      # CPU tensors: the plain twin
    res = teval(matrices, masks, tctx, dt=DT, n_steps=N, low_vel_mode=False)
    cost = to_np(res.cost)
    np.testing.assert_array_equal(to_np(tout["found"]), jout["found"])
    assert jout["found"].all()
    np.testing.assert_array_equal(to_np(tout["histogram"]), jout["histogram"])
    for a in range(A):
        tb, jb = int(tout["best"][a]), int(jout["best"][a])
        assert _same_or_tie(tb, jb, cost[a]), (a, tb, jb)
        if tb != jb:
            continue
        for key in ("x", "y", "theta", "v", "a", "kappa", "s", "s_dot", "s_ddot",
                    "d", "d_dot", "d_ddot", "cost", "terms"):
            np.testing.assert_allclose(to_np(tout[key][a]), jout[key][a],
                                       rtol=RTOL, atol=ATOL, err_msg=f"{key}[{a}]")
    assert tmesh._poses_from(tout).shape == (A, 4)


@pytest.fixture(scope="module")
def ragged_problem():
    return workloads.stacked_cycle_problem(A, CPU, torch.float64, m_bucket=256,
                                           spread=12.0, ragged=True)


def test_batched_equals_sequential_on_ragged_tables(ragged_problem):
    matrices, masks, ctx, ctxs, dt, n = ragged_problem
    assert len({int(c.ref.s.shape[0]) for c in ctxs}) > 1
    out = tmesh.batched_full_cycle(dt=dt, n_steps=n)(matrices, masks, ctx)
    res = teval(matrices, masks, ctx, dt=dt, n_steps=n, low_vel_mode=False)
    for a in range(A):
        seq = teval(matrices[a], masks[a], ctxs[a], dt=dt, n_steps=n,
                    low_vel_mode=False)
        assert bool(seq.found) and bool(out["found"][a])
        assert int(out["best"][a]) == int(seq.best_idx), a
        # the padded rows never enter: costs are bitwise those of the
        # agent alone on its unpadded tables
        np.testing.assert_array_equal(to_np(res.cost[a]), to_np(seq.cost))
        np.testing.assert_array_equal(to_np(res.selectable[a]), to_np(seq.selectable))
        np.testing.assert_array_equal(to_np(out["x"][a]),
                                      to_np(seq.rollout.x[int(seq.best_idx)]))
        np.testing.assert_array_equal(to_np(out["terms"][a]),
                                      to_np(seq.cost_terms[int(seq.best_idx)]))


def test_workload_copy_equals_the_jax_problem(jax_problem):
    """The port's own stacked problem is the JAX tests' problem."""
    matrices, masks, jctx_as_torch, _ = jax_problem
    m2, k2, ctx, _, _, _ = workloads.stacked_cycle_problem(
        A, CPU, torch.float64, n_steps=N, spread=12.0)
    np.testing.assert_array_equal(to_np(m2), to_np(matrices))
    np.testing.assert_array_equal(to_np(k2), to_np(masks))
    for name in ("corridor", "obstacle_xy", "x0_orientation", "weights"):
        np.testing.assert_array_equal(to_np(getattr(ctx, name)),
                                      to_np(getattr(jctx_as_torch, name)))
    for a, b in zip(ctx.ref, jctx_as_torch.ref):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    for a, b in zip(ctx.preds, jctx_as_torch.preds):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_batched_ties_break_to_the_first_index_per_agent(ragged_problem):
    matrices, masks, ctx, _, dt, n = ragged_problem
    fn = tmesh.batched_full_cycle(dt=dt, n_steps=n)
    best = to_np(fn(matrices, masks, ctx)["best"])
    m = matrices.shape[1]
    # every agent's winner again in the last (padding) row, now valid: an
    # exact tie, which must go to the lower index
    dup, dmask = matrices.clone(), masks.clone()
    for a in range(A):
        dup[a, m - 1] = matrices[a, int(best[a])]
        dmask[a, m - 1] = True
    out = fn(dup, dmask, ctx)
    res = teval(dup, dmask, ctx, dt=dt, n_steps=n, low_vel_mode=False)
    for a in range(A):
        assert float(res.cost[a, m - 1]) == float(res.cost[a, int(best[a])])
        assert bool(res.selectable[a, m - 1])
    np.testing.assert_array_equal(to_np(out["best"]), best)
    # and the other way round: the winner's copy in row 0 takes over
    dup0 = matrices.clone()
    for a in range(A):
        dup0[a, 0] = matrices[a, int(best[a])]
    np.testing.assert_array_equal(to_np(fn(dup0, masks, ctx)["best"]), np.zeros(A))


def test_dummy_agents_are_not_found_and_touch_nobody(ragged_problem):
    matrices, masks, ctx, _, dt, n = ragged_problem
    fn = tmesh.batched_full_cycle(dt=dt, n_steps=n)
    want = fn(matrices, masks, ctx)
    dm, dk = matrices.clone(), masks.clone()
    for a in (1, 4):     # the simulation's dummy rows: the neighbour's matrix,
        dm[a] = dm[a - 1]   # t1 = 1, an all-False mask
        dm[a, :, 1] = 1.0
        dk[a] = False
    got = fn(dm, dk, ctx)
    assert not bool(got["found"][1]) and not bool(got["found"][4])
    assert int(got["best"][1]) == 0
    keep = [a for a in range(A) if a not in (1, 4)]
    for key in want:
        np.testing.assert_array_equal(to_np(got[key])[keep], to_np(want[key])[keep],
                                      err_msg=key)


def test_unported_batched_options_raise():
    """Every batched option constructs now, the device mesh of the agent axis
    included; a mesh that the agents do not divide over raises the JAX
    package's ValueError at the step, before any collective (a stand-in mesh
    of three ranks suffices: the worlds themselves are `test_torch_mesh.py`'s)."""
    from frenetix_tpu_torch.io.scenario_factory import make_highway
    from frenetix_tpu_torch.parallel.batched_sim import BatchedAgentStepper

    class ThreeRanks:
        mesh = torch.arange(3)
        mesh_dim_names = ("agents",)

        def size(self):
            return 3

    cfg = tconfig.FrenetixConfig(dtype="float64")
    cfg.simulation.start_multiagent = True
    sim = Simulation(make_highway(n_steps=80), cfg, CPU)
    stepper = BatchedAgentStepper(cfg, sim.agents, CPU, mesh=ThreeRanks())
    with pytest.raises(ValueError, match="agent count 2 must divide evenly"):
        stepper._cycle(torch.zeros(2, 4, 13), torch.zeros(2, 4, dtype=torch.bool), None)
    for kw in (dict(resp_weight=0.2), dict(occlusion=True),
               dict(occlusion=True, occ_um_weight=1.0)):
        assert callable(tmesh.batched_full_cycle(dt=DT, n_steps=N, **kw))


# --------------------------------------------------------- peer predictions


def _assert_preds_close(tp, jp):
    for name in jp._fields:
        a, b = to_np(getattr(tp, name)), np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("with_active", [False, True])
def test_agent_pose_predictions_match_jax(with_active):
    import jax.numpy as jnp
    from frenetix_tpu.parallel.mesh import agent_pose_predictions as jfn

    rng = np.random.default_rng(5)
    poses = rng.normal(size=(5, 4)) * np.array([30.0, 5.0, 1.0, 4.0])
    active = np.array([True, False, True, True, False]) if with_active else None
    kw = dict(horizon=7, dt=0.1, length=5.0, width=2.2, cov_pos=0.05)
    jp = jfn(jnp.asarray(poses), **kw,
             active=None if active is None else jnp.asarray(active))
    tp = tmesh.agent_pose_predictions(
        t64(poses), **kw, active=None if active is None else torch.as_tensor(active))
    _assert_preds_close(tp, jp)
    assert float(tp.covs[0, 0, 0, 0, 0]) == 0.1       # max(cov_pos, 0.1)


@pytest.mark.parametrize("offset", [1, 4])
def test_agent_plan_predictions_match_jax(offset):
    import jax.numpy as jnp
    from frenetix_tpu.parallel.mesh import agent_plan_predictions as jfn

    rng = np.random.default_rng(6)
    bank = rng.normal(size=(4, 12, 4))
    bank_len = np.array([12, 5, 0, 9])
    active = np.array([True, True, True, False])
    kw = dict(horizon=8, length=5.0, width=2.2, cov_pos=0.5)
    jp = jfn(jnp.asarray(bank), jnp.asarray(bank_len), offset, **kw,
             active=jnp.asarray(active))
    tp = tmesh.agent_plan_predictions(t64(bank), torch.as_tensor(bank_len), offset,
                                      **kw, active=torch.as_tensor(active))
    _assert_preds_close(tp, jp)


def test_concat_obstacles_matches_jax():
    import jax.numpy as jnp
    from frenetix_tpu.parallel.mesh import (
        agent_pose_predictions as jpose, concat_obstacles as jcat,
    )

    rng = np.random.default_rng(7)
    kw = dict(horizon=6, dt=0.1, length=4.5, width=1.8, cov_pos=0.5)
    p1, p2 = rng.normal(size=(3, 4)), rng.normal(size=(3, 4))
    jp = jcat(jpose(jnp.asarray(p1), **kw), jpose(jnp.asarray(p2), **kw))
    tp = tmesh.concat_obstacles(tmesh.agent_pose_predictions(t64(p1), **kw),
                                tmesh.agent_pose_predictions(t64(p2), **kw))
    assert tp.means.shape == (3, 6, 6, 2)
    _assert_preds_close(tp, jp)


# ------------------------------------------------------- K1 on stacked tables


def test_k1_wrapper_on_stacked_table_equals_per_agent_twin(ragged_problem):
    _, _, ctx, _, _, _ = ragged_problem
    rng = np.random.default_rng(8)
    a_n, r = ctx.ref.s.shape
    s = t64(rng.uniform(-5.0, 230.0, size=(a_n, 64, 31)))    # some out of domain
    tabs = tfr.interp_ref_tables(ctx.ref, s, extra_tables=ctx.corridor,
                                 window_rows=768, window_anchor=s[:, 0, 0])
    idx = to_np(tabs["idx"])
    assert idx.min() >= 0 and idx.max() <= r - 2    # row+1 stays in the agent
    for a in range(a_n):
        ref_a = type(ctx.ref)(*(f[a] for f in ctx.ref))
        one = tfr.interp_ref_tables(ref_a, s[a], extra_tables=ctx.corridor[a],
                                    window_rows=768, window_anchor=s[a, 0, 0])
        for key in ("alpha", "theta_lerp", "k_r", "k_r_d", "x", "y", "lam",
                    "in_domain", "idx"):
            np.testing.assert_array_equal(to_np(tabs[key][a]), to_np(one[key]),
                                          err_msg=f"{key}[{a}]")
        for got, want in zip(tabs["extras"], one["extras"]):
            np.testing.assert_array_equal(to_np(got[a]), to_np(want))

    # the wrapper itself: rows a·R + i of the stacked table against the plain
    # twin on agent a's own table
    tables = torch.stack([ctx.ref.theta, ctx.ref.kappa, ctx.ref.xy[..., 0]], dim=-1)
    gidx = torch.as_tensor(rng.integers(0, r - 1, size=(a_n, 500)), dtype=torch.int32)
    lam = t64(rng.uniform(-0.5, 1.5, size=(a_n, 500)))
    base = (torch.arange(a_n, dtype=torch.int32) * r)[:, None]
    got = table_interp.interp_rows(tables.reshape(-1, 3).contiguous(),
                                   (gidx + base).reshape(-1).contiguous(),
                                   lam.reshape(-1).contiguous()).reshape(3, a_n, 500)
    for a in range(a_n):
        want = table_interp.interp_rows_plain(tables[a].contiguous(), gidx[a], lam[a])
        np.testing.assert_array_equal(to_np(got[:, a]), to_np(want))


# ---------------------------------------------------------------- simulation


def _states(sim):
    return {a.id: np.array([[*s.position, s.velocity] for s in a.record.states])
            for a in sim.agents}


@pytest.fixture(scope="module")
def jax_multiagent_run():
    from frenetix_tpu.io.scenario_factory import make_highway
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    cfg = JaxConfig(dtype="float64")
    cfg.simulation.start_multiagent = True
    sim = JaxSimulation(make_highway(n_steps=80), cfg)
    return sim.run(), _states(sim)


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_multiagent_simulation_matches_jax(jax_multiagent_run, batched):
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    jres, jstates = jax_multiagent_run
    cfg = tconfig.FrenetixConfig(dtype="float64")
    cfg.simulation.start_multiagent = True
    cfg.simulation.batched_device_agents = batched
    sim = Simulation(make_highway(n_steps=80), cfg, CPU)
    assert len(sim.agents) == 2
    res = sim.run()
    assert res.steps == jres.steps
    assert ({k: v.name for k, v in res.agent_status.items()}
            == {k: v.name for k, v in jres.agent_status.items()})
    if not batched:      # the batched path records one share per level
        assert len(res.planning_times) == len(jres.planning_times)
    states = _states(sim)
    for aid, want in jstates.items():
        assert states[aid].shape == want.shape
        np.testing.assert_allclose(states[aid], want, atol=1e-9)
    if batched:
        assert sim._batched_stepper is not None and sim._batched_max_m >= 256
        batches = [b for a in sim.agents for b in a.record.batch_planning_times]
        assert batches and all(1 <= n <= 2 for _, n in batches)
        assert sim._last_poses_all.shape == (2, 4)


def test_fetch_selection_is_one_copy_and_exact():
    rng = np.random.default_rng(9)
    out = {
        "x": torch.as_tensor(rng.normal(size=(3, 31)), dtype=torch.float32),
        "best": torch.tensor([0, 1023, 16_777_215], dtype=torch.int32),
        "found": torch.tensor([True, False, True]),
        "cost": torch.as_tensor(rng.normal(size=3), dtype=torch.float32),
        "terms": torch.as_tensor(rng.normal(size=(3, 13)), dtype=torch.float32),
        "histogram": torch.as_tensor(rng.integers(0, 1024, size=(3, 11)),
                                     dtype=torch.int32),
    }
    host = Simulation._fetch_selection(out)
    assert host["best"].tolist() == [0, 1023, 16_777_215]
    assert host["found"].tolist() == [True, False, True]
    for key in ("x", "cost", "terms"):
        np.testing.assert_array_equal(host[key], out[key].numpy())
    np.testing.assert_array_equal(host["histogram"], out["histogram"].numpy())


@pytest.mark.parametrize("sim_overrides", [
    {"start_multiagent": True},
    {"start_multiagent": True, "number_of_agents": 3},
    {"start_multiagent": True, "number_of_agents": 3,
     "select_agents_randomly": True, "agent_selection_seed": 4},
    {"start_multiagent": True, "use_specific_agents": True, "agent_ids": [102, 105]},
])
def test_agent_selection_matches_jax(sim_overrides):
    from frenetix_tpu.io.scenario_factory import make_convoy as jmake
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig
    from frenetix_tpu_torch.io.scenario_factory import make_convoy

    jcfg, tcfg = JaxConfig(dtype="float64"), tconfig.FrenetixConfig(dtype="float64")
    for k, v in sim_overrides.items():
        setattr(jcfg.simulation, k, v)
        setattr(tcfg.simulation, k, v)
    want = [a.id for a in JaxSimulation(jmake(), jcfg).agents]
    got = [a.id for a in Simulation(make_convoy(), tcfg, CPU).agents]
    assert got == want and len(got) >= 2


def test_peer_rows_and_eviction_match_jax():
    """Two slots for three peers: the farthest scenario obstacles are evicted
    and every peer keeps a row, as in the JAX simulation."""
    from frenetix_tpu.io.scenario_factory import make_convoy as jmake
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig
    from frenetix_tpu_torch.io.scenario_factory import make_convoy

    jcfg, tcfg = JaxConfig(dtype="float64"), tconfig.FrenetixConfig(dtype="float64")
    for cfg in (jcfg, tcfg):
        cfg.simulation.start_multiagent = True
        cfg.simulation.number_of_agents = 3
        cfg.prediction.max_obstacles = 5
        cfg.prediction.use_sensor_model = False
    jsim = JaxSimulation(jmake(), jcfg)
    tsim = Simulation(make_convoy(), tcfg, CPU)
    jpd, jids = jsim._predictions_for_step(0)
    tpd, tids = tsim._predictions_for_step(0)
    assert jids == tids
    for ja, ta in zip(jsim.agents, tsim.agents):
        want = jsim._agent_predictions(jpd, jids, ja)[0]
        got = tsim._agent_predictions(tpd, tids, ta)[0]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12,
                                       err_msg=f"agent {ja.id} {key}")
        assert int(got["valid"].any(axis=1).sum()) == 5

