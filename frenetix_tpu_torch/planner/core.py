"""The replanning cycle: (M, 13) sampling matrix → selected candidate.

PyTorch port of `frenetix_tpu/planner/core.py`:

    rollout (polynomials + table lookup (K1) + feasibility)  ops.kinematics
    → cost stack                                              ops.costs
    → prediction collisions + corridor road departure         ops.collision
    → masked argmin, first index on ties                      here

On the card the rollout is kernel K2 (`ops.rollout_kernel`) and the stages
after it, up to the selectable mask, are kernel K3 (`ops.cycle_kernel`, one
launch); their plain twins `rollout_candidates_plain` and
`cycle_stages_plain` run on the CPU.

Everything stays on the context's device; nothing is copied to the host.
`evaluate_cycle` is compiled per signature (`utils.compiled`: a CUDA graph
captured once and replayed), as the JAX package jits it; its body is
`evaluate_cycle_eager`.

The agent axis: every op of the cycle accepts leading batch dimensions (the
design chosen over folding agents into the candidate axis).  A matrix
(A, M, 13) with a mask (A, M) and a context whose per-agent leaves start with
A (`parallel.mesh.stack_cycle_contexts`; `veh` and `weights` stay shared)
evaluates all agents in one pass, with ONE K1 launch on the stacked tables,
and returns results that start with A.  All reductions run over trailing
axes, so agent a's slice equals the cycle of agent a alone.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from frenetix_tpu_torch.geometry.refpath import RefPathTable
from frenetix_tpu_torch.ops import collision as coll
from frenetix_tpu_torch.ops import cycle_kernel
from frenetix_tpu_torch.ops import costs as costs_mod
from frenetix_tpu_torch.ops.costs import PredictionTensors
from frenetix_tpu_torch.ops.kinematics import Rollout, VehicleParams, rollout_candidates
from frenetix_tpu_torch.utils.compiled import compiled

__all__ = ["CycleContext", "CycleResult", "evaluate_cycle", "evaluate_cycle_eager",
           "cycle_stages", "cycle_stages_plain", "context_from_numpy"]

_BIG = 1e15


class CycleContext(NamedTuple):
    """Everything a cycle needs besides the sampling matrix (tensors on one
    device; `veh` holds Python floats)."""

    ref: RefPathTable                 # fields are tensors
    veh: VehicleParams
    weights: torch.Tensor             # (K,) in costs.COST_TERM_ORDER
    preds: PredictionTensors
    obstacle_xy: torch.Tensor         # (O, 2) current obstacle positions
    obstacle_valid: torch.Tensor      # (O,) bool
    corridor: torch.Tensor            # (R, 2) drivable d_min/d_max per vertex
    lane_segments: torch.Tensor       # (S, 2, 2) lanelet centerline segments
    lane_valid: torch.Tensor          # (S,) bool
    x0_orientation: torch.Tensor      # scalar
    desired_velocity: torch.Tensor    # scalar
    desired_avg_velocity: torch.Tensor  # scalar


class CycleResult(NamedTuple):
    rollout: Rollout
    cost_terms: torch.Tensor      # (M, K)
    cost: torch.Tensor            # (M,) weighted total
    collides: torch.Tensor        # (M,) bool — prediction collision
    boundary_step: torch.Tensor   # (M,) int32 — first off-road step, -1 if none
    boundary_harm: torch.Tensor   # (M,) — log-reg harm if leaving the road
    selectable: torch.Tensor      # (M,) bool — feasible ∧ valid ∧ ¬coll ∧ on-road
    best_idx: torch.Tensor        # () int32 — argmin cost over selectable
    found: torch.Tensor           # () bool — any selectable candidate
    histogram: torch.Tensor       # (11,) int32 infeasibility histogram


def _boundary_harm(v, coeff_const, coeff_speed):
    """Logistic-regression injury probability 1/(1+exp(-(c0 + c1·Δv)))."""
    return 1.0 / (1.0 + torch.exp(-(coeff_const + coeff_speed * v)))


@compiled(static=("dt", "n_steps", "low_vel_mode", "quintic_lon", "check_boundary",
                  "table_window", "compensated_sum"))
def evaluate_cycle(
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    ctx: CycleContext,
    *,
    dt: float,
    n_steps: int,
    low_vel_mode: bool,
    quintic_lon: bool = False,
    check_boundary: bool = True,
    table_window: int = 768,
    compensated_sum: bool = False,
    harm_coeffs=(-7.5, 0.0815),
) -> CycleResult:
    """Evaluate and select over one padded sampling matrix; `valid_mask`
    excludes the padding rows (ops.sampling.pad_matrix).  Compiled per
    signature (`utils.compiled`), as JAX jits it; `evaluate_cycle_eager` is
    the body."""
    ro = rollout_candidates(
        matrix,
        ctx.ref,
        ctx.veh,
        dt=dt,
        n_steps=n_steps,
        low_vel_mode=low_vel_mode,
        x0_orientation=ctx.x0_orientation,
        quintic_lon=quintic_lon,
        extra_ref_tables=ctx.corridor if check_boundary else None,
        table_window=table_window,
    )

    stages = cycle_stages(ro, valid_mask, ctx, dt=dt, check_boundary=check_boundary,
                          compensated_sum=compensated_sum, harm_coeffs=harm_coeffs)
    selectable, cost = stages["selectable"], stages["cost"]
    masked_cost = torch.where(selectable, cost, torch.full_like(cost, _BIG))
    # torch.argmin returns the FIRST minimal index on CPU and CUDA alike, so
    # exact ties resolve to the lowest candidate index (per agent)
    best_idx = torch.argmin(masked_cost, dim=-1).to(torch.int32)
    found = torch.any(selectable, dim=-1)

    histogram = torch.sum(ro.inf_slots & valid_mask[..., None], dim=-2).to(torch.int32)

    return CycleResult(rollout=ro, **stages, best_idx=best_idx, found=found,
                       histogram=histogram)


def cycle_stages(ro, valid_mask, ctx: CycleContext, *, dt: float,
                 check_boundary: bool = True, compensated_sum: bool = False,
                 harm_coeffs=(-7.5, 0.0815)) -> dict:
    """The cycle's stages after the rollout: `cost_terms`, `cost`,
    `collides`, `boundary_step`, `boundary_harm` and `selectable` (the
    `CycleResult` fields of those names).

    CPU tensors run the plain twin `cycle_stages_plain`; anything else goes
    to kernel K3 (`ops.cycle_kernel.cycle_fields`), which raises on what it
    does not take."""
    kw = dict(dt=dt, check_boundary=check_boundary, compensated_sum=compensated_sum,
              harm_coeffs=harm_coeffs)
    tensors = (ro.x, valid_mask, ctx.weights, ctx.preds.means, ctx.obstacle_xy)
    if all(t.device.type == "cpu" for t in tensors):
        return cycle_stages_plain(ro, valid_mask, ctx, **kw)
    return cycle_kernel.cycle_fields(ro, valid_mask, ctx, **kw)


def cycle_stages_plain(ro, valid_mask, ctx: CycleContext, *, dt: float,
                       check_boundary: bool = True, compensated_sum: bool = False,
                       harm_coeffs=(-7.5, 0.0815)) -> dict:
    """Plain PyTorch twin of kernel K3, the stages on the CPU (arguments as
    `cycle_stages`): the cost stack (`ops.costs`), the prediction collisions
    and the corridor departure (`ops.collision`); on the card ~260 kernels."""
    cost_terms = costs_mod.compute_cost_terms(
        ro,
        dt=dt,
        desired_velocity=ctx.desired_velocity,
        preds=ctx.preds,
        obstacle_xy=ctx.obstacle_xy,
        obstacle_valid=ctx.obstacle_valid,
        desired_avg_velocity=ctx.desired_avg_velocity,
        lane_segments=ctx.lane_segments if ctx.lane_segments.shape[-3] else None,
        lane_valid=ctx.lane_valid,
    )
    cost = costs_mod.weighted_total(cost_terms, ctx.weights,
                                    compensated=compensated_sum)

    rows = ro.x.shape[:-1]
    device = ro.x.device
    collides = coll.prediction_collisions(ro, ctx.preds, ctx.veh)
    if check_boundary:
        boundary_step, v_at = coll.road_departure_corridor(ro, ctx.veh)
        off_road = boundary_step >= 0
        boundary_harm = torch.where(
            off_road, _boundary_harm(v_at, harm_coeffs[0], harm_coeffs[1]),
            torch.zeros_like(v_at),
        )
    else:
        boundary_step = torch.full(rows, -1, dtype=torch.int32, device=device)
        boundary_harm = torch.zeros(rows, dtype=ro.x.dtype, device=device)
        off_road = torch.zeros(rows, dtype=torch.bool, device=device)

    selectable = ro.feasible & ro.valid & ~collides & ~off_road & valid_mask
    return dict(cost_terms=cost_terms, cost=cost, collides=collides,
                boundary_step=boundary_step, boundary_harm=boundary_harm,
                selectable=selectable)


# the body itself: the device-resident run's graph compiles it, and the
# run's tracer patches the run module's name for it
evaluate_cycle_eager = evaluate_cycle.eager


def context_from_numpy(*, ref, veh, weights, preds, obstacle_xy, obstacle_valid,
                       corridor, lane_segments, lane_valid, x0_orientation,
                       desired_velocity, desired_avg_velocity,
                       device: torch.device, dtype=torch.float64) -> CycleContext:
    """The port's CycleContext from the JAX CycleContext's leaves as numpy
    arrays (or anything `np.asarray` takes): `ref` a RefPathTable, `veh` a
    VehicleParams-like named tuple, `preds` a PredictionTensors-like named
    tuple or dict.  Float leaves become `dtype`, masks bool, on `device`.
    The leaves of an agent-stacked JAX context (tables (A, R, ...),
    predictions (A, O, T, ...), scalars (A,), shared `veh` and `weights`)
    give the port's stacked context the same way."""
    def f(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def b(a):
        return torch.as_tensor(np.array(a, dtype=bool), device=device)

    pred_fields = preds if isinstance(preds, dict) else preds._asdict()
    return CycleContext(
        ref=RefPathTable(*(f(x) for x in ref)),
        veh=VehicleParams(*(float(x) for x in veh)),
        weights=f(weights),
        preds=PredictionTensors(**{
            k: (b(v) if k == "valid" else f(v)) for k, v in pred_fields.items()
            if k in PredictionTensors._fields
        }),
        obstacle_xy=f(obstacle_xy),
        obstacle_valid=b(obstacle_valid),
        corridor=f(corridor),
        lane_segments=f(lane_segments),
        lane_valid=b(lane_valid),
        x0_orientation=f(x0_orientation),
        desired_velocity=f(desired_velocity),
        desired_avg_velocity=f(desired_avg_velocity),
    )
