"""The agent axis: stacked per-agent contexts and the batched full cycle.

PyTorch port of the single-device part of `frenetix_tpu/parallel/mesh.py`.
The JAX package maps `planner.core.evaluate_cycle` over a leading agent axis
with `jax.vmap`; here every op of the cycle accepts leading batch dimensions
(see `planner.core`), so `batched_full_cycle` is one call of the same
`evaluate_cycle` on (A, M, 13) matrices and an agent-stacked context:

  - per-agent reference tables and corridors are padded to a common R on the
    host (`_pad_table`: the path length is extrapolated with its last step,
    every other table repeats its last row), lane segments to a common S,
    predictions to a common O;
  - `veh` and `weights` are config-level and stay unstacked;
  - the table lookup (K1) of all agents is ONE kernel launch on the stacked
    (A·R, C) table;
  - the selection (argmin, first index on ties) and the gather of the
    selected candidate's rows happen on the device, per agent.

With `resp_weight` the batched cycle adds the reach-set responsibility term
(agent-stacked grids from `stack_reach_grids`), with `occlusion=True` the
phantom safety gate and the soft occlusion costs, each over ONE pass of the
risk stack for all agents, and then selects again per agent.

The multi-device variant splits the agent axis over the ranks of a
torch.distributed world (`parallel.distributed`): `make_agent_mesh` is a 1-D
`DeviceMesh` over the ranks, and `sharded_full_cycle` runs the batched cycle
on each rank's rows of the full inputs and all-gathers the selection dict
(one collective per call: NCCL on the card, gloo on the CPU), so every rank
returns the same full result, as JAX's `shard_map` + `all_gather` does over
the devices of one process.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from frenetix_tpu_torch.geometry.refpath import RefPathTable
from frenetix_tpu_torch.occlusion import (
    PhantomThresholds, external_occlusion_costs, phantom_safety_mask,
)
from frenetix_tpu_torch.ops.costs import PredictionTensors
from frenetix_tpu_torch.planner.core import CycleContext, evaluate_cycle
from frenetix_tpu_torch.risk.costs import trajectory_risks
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.risk.reachable_set import (
    ReachSetGrid, responsibility_reach_grid,
)
from frenetix_tpu_torch.utils.compiled import compiled

__all__ = [
    "make_agent_mesh",
    "stack_cycle_contexts",
    "stack_reach_grids",
    "batched_full_cycle",
    "sharded_full_cycle",
    "mesh_rows",
    "agent_rows",
    "gather_rows",
    "agent_pose_predictions",
    "agent_plan_predictions",
    "concat_obstacles",
]

# selected-trajectory fields returned per agent (Rollout attr → output key)
_SEL_FIELDS = (
    ("x", "x"), ("y", "y"), ("theta_gl", "theta"), ("v", "v"), ("a", "a"),
    ("kappa_gl", "kappa"), ("s", "s"), ("s_vel", "s_dot"), ("s_acc", "s_ddot"),
    ("d", "d"), ("d_vel", "d_dot"), ("d_acc", "d_ddot"),
)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pad_table(a, r_max, is_pathlength=False):
    """Rows of a per-agent table padded to `r_max`: the path length goes on
    with its last step, any other table repeats its last row."""
    a = _np(a)
    k = r_max - a.shape[0]
    if k <= 0:
        return a[:r_max]
    if is_pathlength:
        step = a[-1] - a[-2]
        return np.concatenate([a, a[-1] + step * np.arange(1, k + 1)])
    return np.concatenate([a, np.repeat(a[-1:], k, axis=0)])


def _pad0(a, n):
    """First axis cut or zero-padded to n rows."""
    a = _np(a)
    if a.shape[0] >= n:
        return a[:n]
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def stack_cycle_contexts(ctxs: list[CycleContext]) -> CycleContext:
    """Stack per-agent CycleContexts along a new leading agent axis.

    Reference tables and corridors are padded to a common R, lane segments
    to a common S, predictions to a common O.  `veh` and `weights` must be
    shared across agents and stay unstacked.  The leaves may be tensors or
    NumPy arrays; the result lies on the first context's device with its
    dtype (CPU and the arrays' dtype for NumPy leaves)."""
    first = ctxs[0].ref.s
    if isinstance(first, torch.Tensor):
        device, dtype = first.device, first.dtype
    else:
        device, dtype = torch.device("cpu"), None

    def tensor(a):
        a = np.ascontiguousarray(a)
        if a.dtype == bool or a.dtype.kind in "iu":
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    r_max = max(int(c.ref.s.shape[0]) for c in ctxs)
    s_max = max(int(c.lane_segments.shape[0]) for c in ctxs)
    o_max = max(int(c.preds.means.shape[0]) for c in ctxs)

    ref = RefPathTable(**{
        name: tensor(np.stack([
            _pad_table(getattr(c.ref, name), r_max, is_pathlength=(name == "s"))
            for c in ctxs]))
        for name in RefPathTable._fields
    })
    preds = PredictionTensors(**{
        name: tensor(np.stack([_pad0(getattr(c.preds, name), o_max) for c in ctxs]))
        for name in PredictionTensors._fields
    })

    def scalars(name):
        return tensor(np.stack([_np(getattr(c, name)) for c in ctxs]))

    weights = ctxs[0].weights
    return CycleContext(
        ref=ref,
        veh=ctxs[0].veh,
        weights=weights if isinstance(weights, torch.Tensor) else tensor(weights),
        preds=preds,
        obstacle_xy=tensor(np.stack([_pad0(c.obstacle_xy, o_max) for c in ctxs])),
        obstacle_valid=tensor(np.stack([_pad0(c.obstacle_valid, o_max)
                                        for c in ctxs])),
        corridor=tensor(np.stack([_pad_table(c.corridor, r_max) for c in ctxs])),
        lane_segments=tensor(np.stack([_pad0(c.lane_segments, s_max)
                                       for c in ctxs])),
        lane_valid=tensor(np.stack([_pad0(c.lane_valid, s_max) for c in ctxs])),
        x0_orientation=scalars("x0_orientation"),
        desired_velocity=scalars("desired_velocity"),
        desired_avg_velocity=scalars("desired_avg_velocity"),
    )


def stack_reach_grids(grids: list[ReachSetGrid]) -> ReachSetGrid:
    """Stack per-agent ReachSetGrids along a new leading agent axis.  All
    grids share O, T and G (the prediction pipeline pads every agent's
    obstacles to the same slot count, and the rasterizer's time and grid
    parameters are config-level); `dt_rs` stays a shared scalar."""
    return ReachSetGrid(
        origin=torch.stack([g.origin for g in grids]),
        occupancy=torch.stack([g.occupancy for g in grids]),
        valid=torch.stack([g.valid for g in grids]),
        cell=torch.stack([g.cell for g in grids]),
        dt_rs=grids[0].dt_rs,
    )


def _select(res, cost=None, best=None, found=None) -> dict:
    """Per-agent gather of the selected candidate: the 12 state rows (A, N+1),
    best (A,), found (A,), cost (A,), terms (A, K), histogram (A, 11).
    `cost`, `best` and `found` replace the cycle's own after a post-pass."""
    cost = res.cost if cost is None else cost
    best = res.best_idx if best is None else best
    found = res.found if found is None else found
    b = best.long()
    n1 = res.rollout.x.shape[-1]
    row = b[..., None, None].expand(b.shape + (1, n1))
    out = {key: torch.gather(getattr(res.rollout, attr), -2, row)[..., 0, :]
           for attr, key in _SEL_FIELDS}
    k = res.cost_terms.shape[-1]
    out.update(
        best=best,
        found=found,
        cost=torch.gather(cost, -1, b[..., None])[..., 0],
        terms=torch.gather(res.cost_terms, -2,
                           b[..., None, None].expand(b.shape + (1, k)))[..., 0, :],
        histogram=res.histogram,
    )
    return out


def post_pass_selection(res, ctx, risks, *, dt, resp_weight=0.0, grid=None,
                        phantom_mask=None, thresholds=None, occ_pm_weight=0.0,
                        occ_um_weight=0.0, occ_ve_weight=0.0, occ_geom=None):
    """The post-passes of one cycle over leading agent axes, in the order of
    the sequential planner: the responsibility term (with `resp_weight` ≠ 0,
    from the ReachSetGrid `grid`), the occlusion safety gate (with a
    `phantom_mask` of the phantom prediction rows: candidates whose phantom
    metrics break `thresholds` leave `selectable`) and the occ_pm / occ_um /
    occ_ve soft costs (occ_um / occ_ve from `occ_geom` = (ego, r_vis, pts,
    pts_valid)), then one argmin over what stays selectable, first index on
    ties.  Returns (cost, selectable, best, found); where nothing is left
    selectable `found` is False and `best` stays the cycle's own."""
    cost, selectable = res.cost, res.selectable
    if resp_weight != 0.0:
        cost = cost + resp_weight * responsibility_reach_grid(res.rollout, grid, risks, dt)
    if phantom_mask is not None:
        safe = phantom_safety_mask(risks, phantom_mask, thresholds or PhantomThresholds(),
                                   rollout=res.rollout, preds=ctx.preds, veh=ctx.veh,
                                   dt=dt)
        selectable = selectable & safe
        if occ_pm_weight or occ_um_weight or occ_ve_weight:
            ego, r_vis, pts, pts_valid = occ_geom or (None,) * 4
            cost = cost + external_occlusion_costs(
                res.rollout, w_pm=occ_pm_weight, w_um=occ_um_weight,
                w_ve=occ_ve_weight, risks=risks, phantom_mask=phantom_mask, ego=ego,
                r_vis=r_vis, occluder_pts=pts, occluder_valid=pts_valid)
    masked = torch.where(selectable, cost, torch.full_like(cost, torch.inf))
    found = torch.any(selectable, dim=-1)
    best = torch.where(found, torch.argmin(masked, dim=-1),
                       res.best_idx.long()).to(torch.int32)
    return cost, selectable, best, found


def batched_full_cycle(*, dt, n_steps, low_vel_mode=False, table_window=768,
                       resp_weight=0.0, occlusion=False, harm_threshold=0.1,
                       risk_threshold=1.0, thresholds=None, occ_pm_weight=0.0,
                       occ_um_weight=0.0, occ_ve_weight=0.0, compensated_sum=False):
    """The full multi-agent cycle on one device.

    Returns fn(matrices (A, M, 13), masks (A, M), stacked_ctx, *extras) →
    dict of (A, ...) selected-trajectory tensors + best/found/cost/terms/
    histogram, all on the context's device.  One K1 launch per call.

    Extras, in order: with `resp_weight` ≠ 0 an agent-stacked ReachSetGrid
    (`stack_reach_grids`; the selection includes the responsibility term);
    with `occlusion=True` an (A, O) bool mask of the phantom prediction rows
    (the selection applies the occlusion safety gate: candidates whose
    phantom metrics break `thresholds`, a PhantomThresholds, leave
    `selectable`; without `thresholds` the gate takes `harm_threshold` and
    `risk_threshold`); with occ_um or
    occ_ve weighted, the per-agent occluder geometry ego (A, 2), r_vis
    (A, K), pts (A, Q, 2), pts_valid (A, Q).

    After either post-pass the argmin runs again over the agent's selectable
    candidates.  When none is left (the gate rejected all), `found` comes
    back False for that agent and `best` stays the cycle's own.

    `fn` is compiled per signature (`utils.compiled`), as JAX jits it; equal
    factory arguments return the same `fn`, so its entries are shared."""
    return _batched_program(*_body_args(
        dt=dt, n_steps=n_steps, low_vel_mode=low_vel_mode, table_window=table_window,
        resp_weight=resp_weight, occlusion=occlusion, harm_threshold=harm_threshold,
        risk_threshold=risk_threshold, thresholds=thresholds,
        occ_pm_weight=occ_pm_weight, occ_um_weight=occ_um_weight,
        occ_ve_weight=occ_ve_weight, compensated_sum=compensated_sum), poses=False)


def _stepper_program(**factory):
    """`batched_full_cycle(**factory)` and the agents' next poses as ONE
    compiled program, fn(...) → (out, poses_all (A, 4)): the batched
    stepper's step on one device (JAX jits the two together)."""
    return _batched_program(*_body_args(**factory), poses=True)


def _body_args(*, dt, n_steps, low_vel_mode=False, table_window=768, resp_weight=0.0,
               occlusion=False, harm_threshold=0.1, risk_threshold=1.0, thresholds=None,
               occ_pm_weight=0.0, occ_um_weight=0.0, occ_ve_weight=0.0,
               compensated_sum=False):
    """`_batched_body`'s arguments from a factory's (the gate's thresholds
    made a PhantomThresholds)."""
    thresholds = thresholds or PhantomThresholds(harm=harm_threshold,
                                                 risk=risk_threshold)
    return (dt, n_steps, low_vel_mode, table_window, resp_weight, occlusion,
            thresholds, occ_pm_weight, occ_um_weight, occ_ve_weight, compensated_sum)


def _batched_body(dt, n_steps, low_vel_mode, table_window, resp_weight, occlusion,
                  thresholds, occ_pm_weight, occ_um_weight, occ_ve_weight,
                  compensated_sum):
    """The eager body of `batched_full_cycle` (its arguments in order, with
    `thresholds` a PhantomThresholds)."""
    use_resp = resp_weight != 0.0
    use_geom = occlusion and (occ_um_weight != 0.0 or occ_ve_weight != 0.0)

    def fn(matrices, masks, ctx, *extras):
        extras = list(extras)
        grid = extras.pop(0) if use_resp else None
        phantom_mask = extras.pop(0) if occlusion else None
        occ_geom = tuple(extras[:4]) if use_geom else None
        res = evaluate_cycle(
            matrices, masks, ctx, dt=dt, n_steps=n_steps,
            low_vel_mode=low_vel_mode, check_boundary=True,
            table_window=table_window, compensated_sum=compensated_sum,
        )
        if not (use_resp or occlusion):
            return _select(res)

        risks = trajectory_risks(
            res.rollout, ctx.preds,
            meta_from_footprint(ctx.preds.lengths, ctx.preds.widths),
            ctx.veh.mass)
        cost, _, best, found = post_pass_selection(
            res, ctx, risks, dt=dt, resp_weight=resp_weight, grid=grid,
            phantom_mask=phantom_mask, thresholds=thresholds,
            occ_pm_weight=occ_pm_weight, occ_um_weight=occ_um_weight,
            occ_ve_weight=occ_ve_weight, occ_geom=occ_geom)
        return _select(res, cost, best, found)

    return fn


@functools.lru_cache(maxsize=None)
def _batched_program(*factory, poses: bool):
    """The compiled batched cycle of `factory` (`_batched_body`'s arguments);
    with `poses` the program also returns the agents' next poses
    (`_poses_from`), as the batched stepper's one program."""
    body = _batched_body(*factory)
    if not poses:
        return compiled(body)

    def with_poses(matrices, masks, ctx, *extras):
        out = body(matrices, masks, ctx, *extras)
        return out, _poses_from(out)

    return compiled(with_poses)


def _poses_from(out):
    """Executed pose (x, y, θ, v) of every agent at the next control step."""
    return torch.stack(
        [out["x"][:, 1], out["y"][:, 1], out["theta"][:, 1], out["v"][:, 1]],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# the agent axis over the ranks of a torch.distributed world
# ---------------------------------------------------------------------------


def make_agent_mesh(devices=None, axis_name: str = "agents"):
    """1-D `DeviceMesh` over the ranks of the torch.distributed world, or
    over the first `devices` ranks (an int) or the listed ranks; agents (or
    scenarios) split along it.  Every rank of the world calls it, in the same
    order (it makes a process group).  The device type follows the world's
    backend: "cuda" under NCCL, "cpu" under gloo."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_agent_mesh needs a torch.distributed world "
                           "(parallel.distributed.initialize)")
    world = dist.get_world_size()
    if devices is None:
        ranks = list(range(world))
    elif isinstance(devices, int):
        ranks = list(range(devices))
    else:
        ranks = [int(r) for r in devices]
    if not ranks or min(ranks) < 0 or max(ranks) >= world:
        raise ValueError(f"mesh ranks {ranks} do not lie in the world of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))


def check_axis(mesh, axis_name: str) -> None:
    """A mesh built with its own axis name must be used under that name."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names and axis_name not in names:
        raise ValueError(f"axis {axis_name!r} is not an axis of the mesh {names}")


def mesh_rows(mesh, n: int, what: str = "agent count"):
    """(lo, hi): this rank's rows of an axis of `n` rows split evenly over
    the mesh, rank r taking [r·n/W, (r+1)·n/W).  Raises ValueError where n
    does not divide over the mesh (as `shard_map` refuses it) or this rank
    is not in the mesh."""
    size = mesh.size()
    if n % size:
        raise ValueError(f"{what} {n} must divide evenly over the {size}-rank mesh")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    per = n // size
    return coord[0] * per, (coord[0] + 1) * per


def agent_rows(x, lo: int, hi: int):
    """Rows lo:hi of the leading agent axis of a tensor, or of every tensor
    in a (named) tuple such as a CycleContext, a ReachSetGrid or the occluder
    geometry.  A CycleContext's `weights` are config-level and stay whole,
    as do scalars (`veh`, `dt_rs`); None stays None."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi]
    if isinstance(x, CycleContext):
        return x._replace(**{f: agent_rows(getattr(x, f), lo, hi)
                             for f in x._fields if f != "weights"})
    if isinstance(x, tuple):
        rows = [agent_rows(v, lo, hi) for v in x]
        return type(x)(*rows) if hasattr(x, "_fields") else tuple(rows)
    return x


def gather_rows(mesh, out: dict) -> dict:
    """Every rank's rows of a dict of (n, ...) tensors, all-gathered into
    (W·n, ...) in rank order, the same on every rank of the mesh.

    ONE collective: the leaves are packed into one (n, L) buffer of the
    dict's floating dtype (indices, counters and flags are integers below
    2^24, exact in float32), gathered, and split again into their own shapes
    and dtypes."""
    keys = list(out)
    dtype = next(v.dtype for v in out.values() if v.is_floating_point())
    n = out[keys[0]].shape[0]
    flat = torch.cat([out[k].to(dtype).reshape(n, -1) for k in keys], dim=1)
    parts = [torch.empty_like(flat) for _ in range(mesh.size())]
    dist.all_gather(parts, flat, group=mesh.get_group())
    full = torch.cat(parts)
    res, col = {}, 0
    for k in keys:
        v = out[k]
        w = int(np.prod(v.shape[1:], dtype=np.int64))
        res[k] = full[:, col:col + w].reshape((full.shape[0],) + tuple(v.shape[1:])) \
            .to(v.dtype)
        col += w
    return res


def sharded_full_cycle(mesh, *, dt, n_steps, low_vel_mode=False, table_window=768,
                       axis_name="agents", resp_weight=0.0, occlusion=False,
                       harm_threshold=0.1, risk_threshold=1.0, thresholds=None,
                       occ_pm_weight=0.0, compensated_sum=False, occ_um_weight=0.0,
                       occ_ve_weight=0.0):
    """The full multi-agent cycle with the agent axis split over `mesh`.

    fn(matrices (A, M, 13), masks (A, M), stacked_ctx, *extras) →
    (out, poses_all): every rank takes the full inputs, runs
    `batched_full_cycle` on its rows [r·A/W, (r+1)·A/W) (one K1 launch on
    its (A/W·R, C) table) and all-gathers the selection dict, so `out` (the
    per-agent dict of `batched_full_cycle`) and `poses_all` (A, 4: x, y, θ,
    v) are the same full result on every rank.  Feed `poses_all` to
    `agent_pose_predictions` to build the next cycle's obstacle tensors on
    the device.

    A must divide over the mesh (ValueError otherwise; pad with agents whose
    masks are all-False: their `found` comes back False).  Extras, split
    along the agent axis like the contexts, in order: an agent-stacked
    ReachSetGrid iff `resp_weight` ≠ 0; the (A, O) phantom-row mask iff
    `occlusion`; the occluder geometry ego, r_vis, pts, pts_valid iff occ_um
    or occ_ve is weighted (see `batched_full_cycle`).  Without `thresholds`
    the gate takes `harm_threshold` and `risk_threshold`.

    Ranks of the world outside a smaller mesh run nothing and receive the
    gathered result from the mesh's first rank, so that every rank of the
    world ends the call with the same selection."""
    check_axis(mesh, axis_name)
    local = _batched_body(*_body_args(
        dt=dt, n_steps=n_steps, low_vel_mode=low_vel_mode, table_window=table_window,
        resp_weight=resp_weight, occlusion=occlusion, harm_threshold=harm_threshold,
        risk_threshold=risk_threshold, thresholds=thresholds,
        occ_pm_weight=occ_pm_weight, occ_um_weight=occ_um_weight,
        occ_ve_weight=occ_ve_weight, compensated_sum=compensated_sum))
    root = int(mesh.mesh.reshape(-1)[0])

    # the rank's program: its rows of the cycle and the gather (the
    # all-gather is captured with the rest under NCCL)
    @compiled
    def rank_cycle(matrices, masks, ctx, *extras):
        return gather_rows(mesh, local(matrices, masks, ctx, *extras))

    def fn(matrices, masks, ctx, *extras):
        a_n = matrices.shape[0]
        if a_n % mesh.size():
            raise ValueError(f"agent count {a_n} must divide evenly over the "
                             f"{mesh.size()}-rank mesh")
        inside = mesh.get_coordinate() is not None
        out = None
        if inside:
            lo, hi = mesh_rows(mesh, a_n)
            out = rank_cycle(matrices[lo:hi], masks[lo:hi], agent_rows(ctx, lo, hi),
                             *(agent_rows(e, lo, hi) for e in extras))
        if mesh.size() < dist.get_world_size():
            box = [{k: v.cpu() for k, v in out.items()} if inside else None]
            dist.broadcast_object_list(box, src=root)
            out = {k: v.to(matrices.device) for k, v in box[0].items()}
        return out, _poses_from(out)

    return fn


def _peer_rows(means, orientations, velocities, in_plan, cov_pos, length, width,
               active):
    """PredictionTensors (..., A observers, A obstacles, T, ...) from per-agent
    rows (..., A, T, ...): every observer sees all rows but its own.  Leading
    axes (a scenario axis) ride along."""
    lead = tuple(means.shape[:-3])
    a, horizon = means.shape[-3], means.shape[-2]
    dtype, device = means.dtype, means.device
    eye2 = torch.eye(2, dtype=dtype, device=device)
    not_self = ~torch.eye(a, dtype=torch.bool, device=device)
    if active is not None:
        not_self = not_self & active[..., None, :]
    valid = not_self[..., None].expand(lead + (a, a, horizon))
    if in_plan is not None:
        valid = valid & in_plan[..., None, :, :]
    return PredictionTensors(
        means=means[..., None, :, :, :].expand(lead + (a, a, horizon, 2)),
        inv_covs=(eye2 / cov_pos).expand(lead + (a, a, horizon, 2, 2)),
        covs=(eye2 * cov_pos).expand(lead + (a, a, horizon, 2, 2)),
        orientations=orientations[..., None, :, :].expand(lead + (a, a, horizon)),
        velocities=velocities[..., None, :, :].expand(lead + (a, a, horizon)),
        lengths=torch.full(lead + (a, a), length, dtype=dtype, device=device),
        widths=torch.full(lead + (a, a), width, dtype=dtype, device=device),
        valid=valid,
    )


def agent_pose_predictions(poses_all, *, horizon: int, dt: float, length: float,
                           width: float, cov_pos: float, active=None):
    """Obstacle tensors from all agents' poses, on their device.

    poses_all (..., A, 4: x, y, θ, v) → PredictionTensors with O = A obstacles
    per observing agent: constant-velocity extrapolation of every agent's
    pose; `valid[i, j] = (i != j)` masks each agent's own row, and an optional
    `active` (..., A) bool masks terminated agents.  The variance is
    max(cov_pos, 0.1)."""
    dtype = poses_all.dtype
    pos, th, v = poses_all[..., :2], poses_all[..., 2], poses_all[..., 3]
    steps = torch.arange(1, horizon + 1, dtype=dtype, device=poses_all.device) * dt
    heading = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)       # (A, 2)
    means = pos[..., None, :] + (v[..., None] * steps)[..., None] \
        * heading[..., None, :]                                         # (A, T, 2)
    shape = th.shape + (horizon,)
    return _peer_rows(means, th[..., None].expand(shape),
                      v[..., None].expand(shape), None,
                      max(cov_pos, 0.1), length, width, active)


def agent_plan_predictions(bank, bank_len, offset, *, horizon: int, length: float,
                           width: float, cov_pos: float, active=None):
    """Peer rows from the agents' currently executing plans.

    `bank` (..., A, W, 4: center x, y, θ, v): bank[a, j] is agent a's state j
    steps after its last replan; `bank_len` (..., A) the number of valid rows;
    `offset` the index of the first predicted step (an int, or a one-element
    integer tensor on the bank's device).  Row i gathers bank[offset + i],
    clamped to bank_len − 1 (the last valid pose pads the tail), and is valid
    while offset + i < bank_len."""
    device = bank.device
    idx = offset + torch.arange(horizon, device=device)                 # (T,)
    idx_c = torch.clamp(torch.minimum(idx, bank_len[..., None] - 1), min=0)
    rows = torch.gather(
        bank, -2, idx_c[..., None].expand(idx_c.shape + (4,)).long())
    in_plan = idx < bank_len[..., None]                                 # (A, T)
    return _peer_rows(rows[..., :2], rows[..., 2], rows[..., 3], in_plan,
                      cov_pos, length, width, active)


# the obstacle axis of every PredictionTensors field, counted from the end
_OBSTACLE_AXIS = dict(means=-3, inv_covs=-4, covs=-4, orientations=-2,
                      velocities=-2, lengths=-1, widths=-1, valid=-2)


def concat_obstacles(p1: PredictionTensors, p2: PredictionTensors) -> PredictionTensors:
    """Concatenate two (..., A, O, ...) prediction-tensor sets along the
    obstacle axis (scenario obstacles + agent poses)."""
    return PredictionTensors(*(
        torch.cat([getattr(p1, f), getattr(p2, f)], dim=_OBSTACLE_AXIS[f])
        for f in PredictionTensors._fields))
