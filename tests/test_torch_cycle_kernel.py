"""Kernel K3 (`csrc/cycle.cu`, wrapper `ops/cycle_kernel.py`): the cycle's
stages after the rollout on the card against their plain twin.

`planner.core.cycle_stages` sends CUDA tensors to K3 and CPU tensors to
`cycle_stages_plain` (the stage functions of `ops.costs` and
`ops.collision`).  On the card, for the same rollout and context:

- `collides`, `boundary_step`, `boundary_harm`, `selectable` and the two
  closed-form jerk terms equal the twin's bit for bit, in float32 and
  float64; every term summed over steps or slots, and the total, lies
  within a relative 1e-5 (float32) / 1e-12 (float64) of the twin's, of the
  size of what it adds up; a pick that differs is a tie within that;
- the cases: 0, 4 and 16 slots with invalid slots and steps; no lane
  segments and eight; the boundary check on and off; the compensated total
  on and off; N + 1 = 31 and 51; leading axes (8, 1,024) and (2, 4); the
  dense shape;
- an agent's rows of a batched call equal K3 on that agent alone, bit for
  bit, with its slots trimmed to the last valid one;
- one K3 launch per cycle program: a compiled cycle's replays and a device
  run count K3 as they count K2, and no CUDA tensor reaches the twin;
- what K3 does not take raises before a launch.

The card's cases carry the `cuda` marker and skip without one; on the card:
`python -m pytest tests/test_torch_cycle_kernel.py -m cuda --noconftest
-q`.  The CPU cases check the dispatch, the argument block and its views.
"""
from __future__ import annotations

import math
from pathlib import Path

import pytest
import torch

from frenetix_tpu_torch.ops import _kernels, collision as coll, costs, cycle_kernel
from frenetix_tpu_torch.ops.costs import PredictionTensors
from frenetix_tpu_torch.ops.kinematics import Rollout, rollout_candidates
from frenetix_tpu_torch.planner import core
from frenetix_tpu_torch.utils import compiled as C
from frenetix_tpu_torch.workloads import dense_cycle_problem, stacked_cycle_problem

from torch_parity import c_struct_fields, ctypes_fields, host_count

SOURCE = Path(__file__).resolve().parents[1] / "frenetix_tpu_torch" / "csrc" / "cycle.cu"
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
JERK_TERMS = (2, 3)         # lateral and longitudinal: closed form, per row
RESPONSIBILITY = 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rollout(matrix, ctx, dt, n_steps, check_boundary=True):
    return rollout_candidates(matrix, ctx.ref, ctx.veh, dt=dt, n_steps=n_steps,
                              low_vel_mode=False, x0_orientation=ctx.x0_orientation,
                              extra_ref_tables=ctx.corridor if check_boundary else None,
                              table_window=768)


def _reshape_lead(ro, lead):
    """The rollout with its leading agent axes made `lead`."""
    def f(t):
        return t.reshape(lead + t.shape[1:])
    return Rollout(*(None if v is None else (tuple(f(e) for e in v) if name == "extras"
                                              else f(v))
                     for name, v in zip(Rollout._fields, ro)))


def _varied(ro, ctx, n_slots, n_segments, seed=0):
    """`ctx` with predictions of `n_slots` slots per agent built from the
    rollout (every fourth slot's means on a candidate's path from its tenth
    step on, the others 25 m aside; orientations, sizes and covariances
    drawn; a third of the slots and a tenth of the steps invalid, slot 0
    valid on the path and the last slot never), current obstacles at step 0
    (a strided view, as the device run has them), `n_segments` lane
    segments across the candidates (every third invalid), positive weights
    and per-agent speeds."""
    g = torch.Generator().manual_seed(seed)
    dtype, device = ro.x.dtype, ro.x.device
    lead, (m_rows, n1) = tuple(ro.x.shape[:-2]), tuple(ro.x.shape[-2:])
    a = math.prod(lead)
    t = n1 - 1
    x, y = (f.reshape(a, m_rows, n1).double().cpu() for f in (ro.x, ro.y))

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)

    rows = torch.randint(0, m_rows, (a, n_slots), generator=g)
    pick = torch.arange(a)[:, None]
    means = torch.stack([x[pick, rows, 1:], y[pick, rows, 1:]], dim=-1)   # (a, O, t, 2)
    means = means + u(a, n_slots, t, 2, lo=-1.5, hi=1.5)
    aside = torch.arange(n_slots) % 4 != 0
    means[:, aside, :, 1] += 25.0
    turn = u(a, n_slots, t, lo=-math.pi, hi=math.pi)
    rot = torch.stack([torch.stack([turn.cos(), -turn.sin()], -1),
                       torch.stack([turn.sin(), turn.cos()], -1)], -2)
    scale = torch.diag_embed(u(a, n_slots, t, 2, lo=0.3, hi=3.0))
    covs = rot @ scale @ rot.transpose(-1, -2)
    valid = u(a, n_slots, 1) > 0.33
    valid = valid & (u(a, n_slots, t) > 0.1)
    valid[:, ~aside, : t // 3] = False      # on the paths only once they part
    if n_slots:
        valid[:, 0, t // 3:] = True
        valid[:, -1] = False
    preds = PredictionTensors(
        means=means, inv_covs=torch.linalg.inv(covs), covs=covs,
        orientations=u(a, n_slots, t, lo=-math.pi, hi=math.pi),
        velocities=torch.zeros(a, n_slots, t, dtype=torch.float64),
        lengths=u(a, n_slots, lo=3.0, hi=6.0), widths=u(a, n_slots, lo=1.5, hi=2.5),
        valid=valid)
    preds = PredictionTensors(*(
        v.reshape(lead + v.shape[1:]).to(device, dtype if v.is_floating_point() else v.dtype)
        for v in preds))

    seg_rows = torch.randint(0, m_rows, (a, n_segments), generator=g)
    steps = torch.randint(0, n1 - 6, (a, n_segments), generator=g)
    pick = torch.arange(a)[:, None]
    ends = [torch.stack([x[pick, seg_rows, steps + k], y[pick, seg_rows, steps + k]], -1)
            for k in (0, 5)]
    segs = torch.stack(ends, dim=-2) + u(a, n_segments, 2, 2, lo=-1.0, hi=1.0)
    lane_valid = (torch.arange(n_segments) % 3 != 2).expand(a, n_segments)
    v_mean = ro.v.reshape(a, m_rows, n1).double().mean(-1)[:, 0].cpu()

    def agents(v):
        return v.reshape(lead + v.shape[1:]).to(device)

    return ctx._replace(
        preds=preds, obstacle_xy=preds.means[..., 0, :], obstacle_valid=preds.valid[..., 0],
        lane_segments=agents(segs.to(dtype)), lane_valid=agents(lane_valid.clone()),
        weights=(u(13, lo=0.1, hi=2.0)).to(device, dtype),
        desired_velocity=agents(u(a, lo=5.0, hi=15.0).to(dtype)),
        desired_avg_velocity=agents(v_mean.to(dtype)))


def _bits(t):
    t = t.contiguous()
    return {torch.float32: lambda: t.view(torch.int32),
            torch.float64: lambda: t.view(torch.int64)}.get(t.dtype, lambda: t)()


def _assert_bitwise(g, w, what):
    assert g.shape == w.shape and g.dtype == w.dtype, (
        f"{what}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
    same = _bits(g) == _bits(w)
    assert bool(same.all()), (f"{what}: differs at {int((~same).sum())} of {same.numel()}, "
                              f"first at {tuple(int(i) for i in torch.nonzero(~same)[0])}")


def _scales(ro, terms, dt):
    """Per row and term, the size of what the term adds up: |term|, and for
    path length and velocity, whose summands may cancel, the same sums of
    |v| besides."""
    scale = terms.abs()
    scale[..., 5] += costs.simpson_uniform(ro.v.abs(), dt)
    scale[..., 8] += ro.v.abs().mean(-1)
    return scale


def _assert_matches_twin(got, want, ro, ctx, dt, what):
    """K3's stages against the twin's: flags, steps, harms and jerk terms
    bitwise; sums within RTOL of their size; a differing pick a tie."""
    for name in ("collides", "boundary_step", "boundary_harm", "selectable"):
        _assert_bitwise(got[name], want[name], f"{what}: {name}")
    for k in JERK_TERMS + (RESPONSIBILITY,):
        _assert_bitwise(got["cost_terms"][..., k], want["cost_terms"][..., k],
                        f"{what}: cost term {costs.COST_TERM_ORDER[k]}")
    rtol = RTOL[ro.x.dtype]
    scale = _scales(ro, want["cost_terms"], dt)
    err = (got["cost_terms"] - want["cost_terms"]).abs()
    bad = err > rtol * scale
    assert not bool(bad.any()), (
        f"{what}: cost terms {sorted({costs.COST_TERM_ORDER[int(i)] for i in torch.nonzero(bad)[:, -1]})} "
        f"beyond {rtol} of their size (largest ratio "
        f"{float((err / scale)[bad].max()):.3e})")
    cost_scale = (scale * ctx.weights.abs()).sum(-1)
    assert bool(((got["cost"] - want["cost"]).abs() <= rtol * cost_scale).all()), (
        f"{what}: total beyond {rtol}")
    big = torch.full_like(want["cost"], 1e15)
    masked_w = torch.where(want["selectable"], want["cost"], big)
    pick_g = torch.argmin(torch.where(got["selectable"], got["cost"], big), -1, keepdim=True)
    gap = masked_w.gather(-1, pick_g) - masked_w.min(-1, keepdim=True).values
    assert bool((gap <= 2 * rtol * cost_scale.gather(-1, pick_g)).all()), (
        f"{what}: a pick differs by more than a tie")


def _both(ro, mask, ctx, dt, **kw):
    before = host_count("kernel.k3.launches")
    got = core.cycle_stages(ro, mask, ctx, dt=dt, **kw)
    launches = host_count("kernel.k3.launches") - before
    want = core.cycle_stages_plain(ro, mask, ctx, dt=dt, **kw)
    torch.cuda.synchronize()
    return got, want, launches


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("check_boundary", [True, False])
def test_cpu_tensors_run_the_plain_twin(check_boundary, compensated):
    """On the CPU the cycle's stages are the plain stage functions, composed
    as the twin composes them, and nothing of K3 loads or counts."""
    cpu = torch.device("cpu")
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cpu, torch.float64, density=1,
                                                            bucket=128)
    ro = _rollout(matrix, ctx, dt, n_steps, check_boundary)
    before = host_count("kernel.k3.launches")
    res = core.evaluate_cycle.eager(matrix, mask, ctx, dt=dt, n_steps=n_steps,
                                    low_vel_mode=False, check_boundary=check_boundary,
                                    compensated_sum=compensated)
    assert host_count("kernel.k3.launches") == before
    assert "cycle" not in _kernels._libraries
    terms = costs.compute_cost_terms(
        ro, dt=dt, desired_velocity=ctx.desired_velocity, preds=ctx.preds,
        obstacle_xy=ctx.obstacle_xy, obstacle_valid=ctx.obstacle_valid,
        desired_avg_velocity=ctx.desired_avg_velocity)
    off_road = torch.zeros_like(ro.feasible)
    if check_boundary:
        step, _ = coll.road_departure_corridor(ro, ctx.veh)
        off_road = step >= 0
        _assert_bitwise(res.boundary_step, step, "boundary_step")
    else:
        assert bool((res.boundary_step == -1).all()) and not bool(res.boundary_harm.any())
    collides = coll.prediction_collisions(ro, ctx.preds, ctx.veh)
    _assert_bitwise(res.cost_terms, terms, "cost_terms")
    _assert_bitwise(res.cost, costs.weighted_total(terms, ctx.weights,
                                                   compensated=compensated), "cost")
    _assert_bitwise(res.collides, collides, "collides")
    _assert_bitwise(res.selectable,
                    ro.feasible & ro.valid & ~collides & ~off_road & mask, "selectable")


def test_the_argument_block_matches_the_kernel_source():
    assert ctypes_fields(cycle_kernel._Args) == c_struct_fields(SOURCE)


def test_k3_refuses_cpu_tensors_before_a_launch():
    cpu = torch.device("cpu")
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cpu, torch.float32, density=1,
                                                            bucket=128)
    ro = _rollout(matrix, ctx, dt, n_steps)
    before = host_count("kernel.k3.launches")
    with pytest.raises(ValueError):
        cycle_kernel.cycle_fields(ro, mask, ctx, dt=dt, check_boundary=True,
                                  compensated_sum=False, harm_coeffs=(-7.5, 0.0815))
    assert host_count("kernel.k3.launches") == before
    assert "cycle" not in _kernels._libraries


def test_k3_refuses_a_window_beyond_shared_memory():
    """A block stages its agent's window in shared memory: more slots than
    the card's 227 KB hold are refused before a launch."""
    cpu = torch.device("cpu")
    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cpu, torch.float64, density=1,
                                                            bucket=128)
    ro = _rollout(matrix, ctx, dt, n_steps)
    many = PredictionTensors(*(v[:1].expand((120,) + v.shape[1:]) for v in ctx.preds))
    ctx = ctx._replace(preds=many)
    with pytest.raises(ValueError, match="shared memory"):
        cycle_kernel._arguments(ro, mask, ctx, dt=dt, check_boundary=True,
                                harm_coeffs=(-7.5, 0.0815))
    few = PredictionTensors(*(v[:1].expand((90,) + v.shape[1:]) for v in ctx.preds))
    cycle_kernel._arguments(ro, mask, ctx._replace(preds=few), dt=dt, check_boundary=True,
                            harm_coeffs=(-7.5, 0.0815))


def _device_run_context(cpu):
    """A stacked context shaped as the device run's: current obstacles as
    strided views of the predictions' step 0, per-agent speeds."""
    matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
        3, cpu, torch.float32, m_bucket=64, spread=12.0, ragged=True, o_slots=16)
    ctx = ctx._replace(obstacle_xy=ctx.preds.means[..., 0, :],
                       obstacle_valid=ctx.preds.valid[..., 0])
    return matrices, masks, ctx, dt, n_steps


@pytest.mark.parametrize("shape", ["dense", "stacked", "device_run"])
def test_the_arguments_view_every_leaf_without_a_copy(shape):
    """The argument block points into the rollout, the mask and the
    context themselves (shared leaves with an agent stride of 0): the
    wrapper adds no copy kernel on the main paths' shapes."""
    cpu = torch.device("cpu")
    if shape == "dense":
        matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cpu, torch.float32,
                                                                density=1, bucket=128)
    elif shape == "stacked":
        matrix, mask, ctx, _, dt, n_steps = stacked_cycle_problem(
            2, cpu, torch.float32, m_bucket=64, spread=12.0, ragged=True, o_slots=16)
    else:
        matrix, mask, ctx, dt, n_steps = _device_run_context(cpu)
    ro = _rollout(matrix, ctx, dt, n_steps)
    args, out, _ = cycle_kernel._arguments(ro, mask, ctx, dt=dt, check_boundary=True,
                                           harm_coeffs=(-7.5, 0.0815))
    preds = ctx.preds
    sources = {
        "x": ro.x, "theta_cl": ro.theta_cl, "d_lo": ro.extras[0], "d_hi": ro.extras[1],
        "coeffs_lat": ro.coeffs_lat, "feasible": ro.feasible, "mask": mask,
        "means": preds.means, "inv_covs": preds.inv_covs, "pred_valid": preds.valid,
        "lengths": preds.lengths, "obstacle_xy": ctx.obstacle_xy,
        "obstacle_valid": ctx.obstacle_valid, "v_des": ctx.desired_velocity,
        "v_avg": ctx.desired_avg_velocity, "weights": ctx.weights,
    }
    for name, t in sources.items():
        assert getattr(args, name) == t.data_ptr(), f"{name} was copied"
    lead = ro.x.shape[:-2]
    assert args.n_agents == math.prod(lead)
    if lead:
        assert args.w_sa == 0 and args.mu_sa == preds.means.stride(0)
    assert (args.ox_so, args.ox_sc) == ctx.obstacle_xy.stride()[-2:]
    assert out["cost_terms"].shape == ro.x.shape[:-1] + (13,)


# ----------------------------------------------------------------- the card


def _stacked(device, dtype, a, m_rows, n_steps=30, seed=0):
    matrices, masks, ctx, _, dt, n_steps = stacked_cycle_problem(
        a, device, dtype, n_steps=n_steps, m_bucket=m_rows, spread=12.0, ragged=True,
        o_slots=16)
    return _rollout(matrices, ctx, dt, n_steps), masks, ctx, dt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_slots", [0, 4, 16])
@pytest.mark.parametrize("n_segments, check_boundary, compensated",
                         [(0, True, False), (8, False, True), (8, True, True)])
def test_k3_equals_the_plain_stages(n_segments, check_boundary, compensated, n_slots,
                                    dtype, cuda_device):
    ro, masks, ctx, dt = _stacked(cuda_device, dtype, 8, 256)
    ro = _reshape_lead(ro, (2, 4))
    ctx = _varied(ro, ctx, n_slots, n_segments, seed=n_slots + n_segments)
    masks = masks.reshape(2, 4, -1)
    got, want, launches = _both(ro, masks, ctx, dt, check_boundary=check_boundary,
                                compensated_sum=compensated)
    assert launches == 1
    what = (f"(2, 4) x 256, O = {n_slots}, S = {n_segments}, boundary {check_boundary}, "
            f"compensated {compensated}, {dtype}")
    _assert_matches_twin(got, want, ro, ctx, dt, what)
    if n_slots:
        assert bool(want["collides"].any()) and bool((~want["collides"]).any()), what
    if check_boundary:
        assert bool((want["boundary_step"] >= 0).any()), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ["dense", "8x1024", "8x1024 N+1=51"])
def test_k3_equals_the_plain_stages_at_scale(shape, dtype, cuda_device):
    if shape == "dense":
        matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cuda_device, dtype)
        ro = _rollout(matrix, ctx, dt, n_steps)
    else:
        ro, mask, ctx, dt = _stacked(cuda_device, dtype, 8, 1024,
                                     n_steps=50 if "51" in shape else 30)
        ctx = _varied(ro, ctx, 16, 8, seed=3)
    got, want, launches = _both(ro, mask, ctx, dt, check_boundary=True,
                                compensated_sum=False)
    assert launches == 1
    _assert_matches_twin(got, want, ro, ctx, dt, f"{shape} {dtype}")


def _agent(ro, ctx, a):
    """Agent a's rollout and context alone, its slots trimmed to the last
    valid one."""
    n = int(ctx.preds.valid[a].any(-1).nonzero().max()) + 1
    preds = PredictionTensors(*(v[a, :n] for v in ctx.preds))
    return (Rollout(*(None if v is None else (tuple(e[a] for e in v) if name == "extras"
                                               else v[a])
                      for name, v in zip(Rollout._fields, ro))),
            ctx._replace(preds=preds, obstacle_xy=preds.means[:, 0],
                         obstacle_valid=preds.valid[:, 0],
                         lane_segments=ctx.lane_segments[a], lane_valid=ctx.lane_valid[a],
                         desired_velocity=ctx.desired_velocity[a],
                         desired_avg_velocity=ctx.desired_avg_velocity[a]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_batched_equals_per_agent(dtype, cuda_device):
    ro, masks, ctx, dt = _stacked(cuda_device, dtype, 8, 1024)
    ctx = _varied(ro, ctx, 16, 8, seed=5)
    batched = core.cycle_stages(ro, masks, ctx, dt=dt, compensated_sum=True)
    for a in range(8):
        ro_a, ctx_a = _agent(ro, ctx, a)
        assert ctx_a.preds.means.shape[0] < 16
        alone = core.cycle_stages(ro_a, masks[a], ctx_a, dt=dt, compensated_sum=True)
        for name, value in alone.items():
            _assert_bitwise(batched[name][a], value, f"agent {a} {name}")


@pytest.mark.cuda
def test_k3_launches_once_per_compiled_replay(cuda_device):
    from frenetix_tpu_torch.planner.core import evaluate_cycle

    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cuda_device, torch.float32,
                                                            density=2, bucket=256)
    C.clear_all()
    kw = dict(dt=dt, n_steps=n_steps, low_vel_mode=False)
    plain_calls = []
    original = costs.compute_cost_terms

    def spy(ro, **k):
        plain_calls.append(ro.x.device.type)
        return original(ro, **k)

    costs.compute_cost_terms = spy
    captures = evaluate_cycle.captures        # (cumulative over the process)
    try:
        first = evaluate_cycle(matrix, mask, ctx, **kw)           # warm-up and capture
        k2, k3 = host_count("kernel.k2.launches"), host_count("kernel.k3.launches")
        for _ in range(3):
            again = evaluate_cycle(matrix, mask, ctx, **kw)
        torch.cuda.synchronize()
    finally:
        costs.compute_cost_terms = original
    assert host_count("kernel.k3.launches") - k3 == 3
    assert host_count("kernel.k2.launches") - k2 == 3
    assert "cuda" not in plain_calls
    assert evaluate_cycle.captures - captures == 1
    for name in ("cost_terms", "cost", "selectable", "best_idx"):
        _assert_bitwise(getattr(again, name), getattr(first, name), name)
    C.clear_all()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [True, False])
def test_k3_launches_in_a_device_run(graph, cuda_device):
    from frenetix_tpu_torch.io import scenario_factory
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.simulation.start_multiagent = True
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    sim = Simulation(scenario_factory.make_convoy(n_vehicles=2, n_steps=40), cfg,
                     cuda_device)
    sim.max_steps = 12
    run = DeviceSimulation(sim)
    k3 = host_count("kernel.k3.launches")
    res = run.run(graph=graph)
    assert host_count("kernel.k3.launches") - k3 == res.extras["k3_launches"]
    # one K3 after each rollout
    assert res.extras["k3_launches"] == res.extras["k2_launches"] > 0


@pytest.mark.cuda
def test_k3_refuses_what_it_does_not_take(cuda_device):
    ro, masks, ctx, dt = _stacked(cuda_device, torch.float32, 2, 64)
    kw = dict(dt=dt, check_boundary=True, compensated_sum=False)
    before = host_count("kernel.k3.launches")
    with pytest.raises(TypeError):           # float64 weights beside a float32 rollout
        core.cycle_stages(ro, masks, ctx._replace(weights=ctx.weights.double()), **kw)
    with pytest.raises(TypeError):           # a mask that is not bool
        core.cycle_stages(ro, masks.float(), ctx, **kw)
    with pytest.raises(ValueError):          # the predictions on the CPU
        cpu_preds = PredictionTensors(*(v.cpu() for v in ctx.preds))
        core.cycle_stages(ro, masks, ctx._replace(preds=cpu_preds), **kw)
    with pytest.raises(ValueError):          # no corridor columns
        core.cycle_stages(ro._replace(extras=None), masks, ctx, **kw)
    with pytest.raises(ValueError):          # agents that do not broadcast
        core.cycle_stages(ro, masks, ctx._replace(weights=ctx.weights.expand(3, 13)), **kw)
    assert host_count("kernel.k3.launches") == before
