"""Device-resident multi-agent simulation: one fetch per RUN.

PyTorch port of the core of `frenetix_tpu/parallel/device_sim.py`.  The host
loop (`sim.simulation.Simulation.run`) copies a selection to the host after
every replanning pass and then steps the agents in NumPy.  Here the whole
run stays on the device:

    carry: per-agent curvilinear state, pose, status, the peers' plan bank
    body:  goal check → desired velocity → this cycle's prediction window,
           sensor filter and peer rows → sampling matrices built on the
           device → `planner.core.evaluate_cycle` for all agents at once, in
           both kinematics modes and at every densification level → the
           emergency ladder → `replanning_frequency` executed sub-steps with
           the status ladder and the in-order collision sweep
    fetch: ONE device→host copy of statuses, trajectories, selections and
           the selected candidates' costs.

The JAX package compiles the body into a `lax.scan`.  Here the body is a
plain function that only enqueues work: it reads no tensor on the host, so
nothing in the run waits for the device.  Its three runtime branches in the
JAX package (the low-velocity program, a further densification level, each
behind a `lax.cond`) are value-identical to computing both sides and merging
with `where`, which is what this port does.  On a CUDA device the body is the
same program every cycle, so `run()` captures it once into a CUDA graph
(`utils.compiled._Graph`, which warms it up first and so builds the kernels)
and replays the graph `n_cycles` times: the carry lives in fixed buffers
updated with `copy_`, the cycle counter is a device tensor incremented inside
the graph, per-cycle inputs are read with `index_select` on it and outputs go
into preallocated (C, ...) buffers with `index_copy_`.  On the CPU the same
body runs eagerly.

K1 (`ops.table_interp`) runs once per program (kinematics mode × level) per
cycle on the stacked (S·A·R, C) table, inside that program's rollout, K2
(`ops.rollout_kernel`, one launch pair per rollout), and K3
(`ops.cycle_kernel`) once after it.  A run reports their launches in
`extras["k1_launches"]`, `["k2_launches"]` and `["k3_launches"]`: the
change of the host counters `kernel.k1.launches`, `.k2` and `.k3` across
its cycles, which each replay moves by what its capture recorded, as the
eager body moves them by what it launches.

A fleet (`run_fleet`) pads every member to the fleet's maxima with inert
rows and runs the same body over one more leading axis, (S, A, ...).

A captured run serves further input sets of the same statics and shapes,
in one way: a runner's owner (`_Runner.take`) has its inputs copied into
the buffers (`_Runner.load`) before the replays, unless they are there
already.  `share_runner(sims)` gives single scenarios one runner (its
buffers hold the window slots any member fills), so a service that
simulates one scenario after another captures once; a `FleetRunner` gives
one runner to several fleets of S members, sized to the maxima over all
of them, so a service that runs fleet after fleet captures once, and
`run_fleet(chunk=)` runs its chunks through one.  Each result is bitwise
that of its own fresh run.

Tracing (`utils.tracing`): the spans `frenetix.device_sim.load`,
`.fleet.load` (a fleet's stack copied into the buffers),
`.reset`, `.capture`, `.replay` (the loop of a run's cycles), `.fetch` and
`.finalize`; the device span `frenetix.device_sim.cycles`, two timing
events on the stream around that loop; the counters `device_sim.cycles`
(cycles driven), `.captures`, `.fetches` (device→host copies: one per run or
chunk, and one per cycle on the hybrid path), `.programs` (K1 launches of
each captured cycle), and per fleet run `.fleet.members`,
`.fleet.agent_cycles_real` (Σ own agents × own cycles) and
`.fleet.agent_cycles_stacked` (S × agents × cycles of the buffers).  A runner captures again when its graph is stale
(tracing was switched since the capture), so no graph keeps the other
state's nodes.  The runner's graph records no device spans.

The behavior planner runs in one of two ways.  Where
`behavior.device_fsm.build_fsm_tensors` supports the scenario (and
`behavior.device_fsm` is "auto"), the FSM is part of the body
(`behavior.device_fsm.make_fsm_step`): it gives every agent its desired
velocity and stop point, and the quintic stopping program runs every cycle on
a device-built stopping matrix and is merged with `where` for the agents that
want it and found a candidate.  The one fetch also reads the carried `bail`
flag: an FSM that wanted to overtake makes `run()` do the run again on the
hybrid path.  Otherwise the run takes the hybrid path (`_drive_hybrid`): the
host behavior modules run between device cycles, one small fetch of the
carry per cycle, and the single-cycle body takes their velocities and
stopping matrices from input buffers; a reference-path swap restacks the
tables (a new capture only when the tables grow).

The post-passes run in the body as well: the visible-area sensor stage
(`calc_occlusions`: a polar map per agent from the road walls, the scenario
obstacles and the live peers, probed at each window row's corners and
center), the occlusion module (phantom rows from the spawn locator
`phantom_rows`, capped by the host's free slots, then the safety gate and the
occ_pm / occ_um / occ_ve soft costs) and the responsibility term (reach-set
grids rasterized on the device from the cycle's prediction rows, peers
included, once per cycle).  Each program applies them in the batched host
cycle's order and selects again before the emergency ladder
(`mesh.post_pass_selection`).

The runner's buffers hold only the prediction-window slots that some cycle
fills (`_kept_slots`); `DeviceSimulation.tensors` keeps the full width.  The
trim is exact (every sum over obstacle rows adds an invalid row's exact
zero) and shrinks the risk stack's quadrature, which dominates a cycle with
a post-pass.

Wale-Net predictions (`prediction.mode = "walenet"`) take the hybrid path
too: the net reads the agents' executed histories, so no window can be
precomputed.  Per cycle the one carry fetch also brings the previous cycle's
executed sub-steps, the host agents are synced to them as mirrors
(`_sync_exec_mirrors`), the host Simulation builds every agent's rows as its
own loop does (`_hybrid_pred_cycle`: the net, the sensor filter, the peers),
and the body takes them from the input buffers `p_in` in place of its
window and peer rows.  Walenet fleets run their members one after another.

What this module carries of the JAX original: ground-truth,
constant-velocity and Wale-Net predictions with mode-faithful peers, the
full sensor pipeline, progressive densification, low-velocity kinematics,
the emergency ladder in both modes ("stopping", "min_risk"), the
post-passes, the behavior planner (in the run and hybrid), fleets and
chunks, and the torch.distributed mesh (`parallel.mesh.make_agent_mesh`):
with `DeviceSimulation(sim, mesh=...)` every program of a cycle (both
kinematics modes, every level, the stopping program) runs on the rank's
agent rows and all-gathers the selection dict inside the body (one
collective per program and cycle, captured into the CUDA graph with the rest
of the body under NCCL), while the O(A) bookkeeping stays replicated on every
rank; `run_fleet(sims, mesh=...)` gives rank r the members
[r·S/W, (r+1)·S/W), runs them with no collective inside the run, and
gathers the members' results once.  Wale-Net with the occlusion module (as
in the JAX package) raises NotImplementedError here.
The road-departure check of executed poses is skipped, as in the JAX
package: selected plans are corridor-checked inside the cycle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch
import torch.distributed as dist

from frenetix_tpu_torch.behavior.device_fsm import (
    build_fsm_tensors, fsm_carry0, make_fsm_step, pad_fsm_tensors,
)
from frenetix_tpu_torch.geometry.refpath import RefPathTable
from frenetix_tpu_torch.ops import sampling as smp
from frenetix_tpu_torch.ops.collision import obb_overlap
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER, PredictionTensors
from frenetix_tpu_torch.parallel.batched_sim import BatchedAgentStepper
from frenetix_tpu_torch.parallel.mesh import (
    _SEL_FIELDS, _pad_table, agent_plan_predictions, agent_pose_predictions,
    agent_rows, check_axis, concat_obstacles, gather_rows, mesh_rows,
    post_pass_selection,
)
# the body of the cycle, not its compiled program: the run's own CUDA graph
# compiles it (and `utils.parting.RunTrace` patches this name)
from frenetix_tpu_torch.planner.core import CycleContext
from frenetix_tpu_torch.planner.core import evaluate_cycle_eager as evaluate_cycle
from frenetix_tpu_torch.planner.reactive import wants_stopping_mode
from frenetix_tpu_torch.occlusion.occlusion_module import PHANTOM_TYPES, PhantomThresholds
from frenetix_tpu_torch.risk.costs import trajectory_risks
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.risk.reachable_set import (
    build_reach_set_grids_device, lanelet_tensors,
)
from frenetix_tpu_torch.sim.agent import AgentStatus, EgoState
from frenetix_tpu_torch.sim.planner_interfaces import apply_behavior_output
from frenetix_tpu_torch.sim.prediction import ground_truth_predictions
from frenetix_tpu_torch.sim.visible_area import (
    obb_segments_batch, polar_visibility_batch, road_boundary_segments,
)
from frenetix_tpu_torch.utils import tracing
from frenetix_tpu_torch.utils.compiled import _Graph

__all__ = ["DeviceSimulation", "DeviceSimResult", "FleetRunner", "SimTensors",
           "run_fleet", "share_runner"]

# AgentStatus values as plain ints: the status carry is an int32 tensor
_RUNNING, _SUCCESS, _TIMELIMIT, _COLLISION, _ERROR = 1, 2, 3, 4, 5

# the selection margins of a run with `emit_margins` (`select_with_fallback`)
MARGINS = ("margin_gap", "margin_rel")


@dataclass
class SimTensors:
    """Every per-scenario input of the run.  On the host the leaves are NumPy
    arrays (padded and stacked for fleets there); `to` gives the same
    structure as tensors on a device.  A fleet's leaves start with S."""

    ref: RefPathTable          # (A, R, ...) leaves
    corridors: object          # (A, R, 2)
    lane_segments: object      # (A, S, 2, 2)
    lane_valid: object         # (A, S)
    pred_windows: dict         # per-cycle scenario-obstacle windows (C, O, ...)
    cur_obst: object           # (C, O, 3) row-aligned CURRENT obstacle poses
    cur_obst_valid: object     # (C, O) rows present at that cycle's step
    obst_poses: object         # (T+1, O', 3)
    obst_valid: object         # (T+1, O')
    obst_half: object          # (O', 2)
    g_rings: object            # (A, G, E, 2)
    g_ring_valid: object       # (A, G)
    g_ring_v: object           # (A, G, 2)
    g_vo_has: object           # (A,)
    g_vo_int: object           # (A, 2)
    goal_s: object             # (A,)
    has_goal_s: object         # (A,)
    goal_t_hi: object          # (A,)
    has_goal_t: object         # (A,)
    goal_v_mean: object        # (A,)
    max_steps: object          # () int32, the scenario's step budget
    active0: object            # (A,) bool, False rows are fleet padding
    x_cl0: object              # (A, 6)
    pose0: object              # (A, 4) center x, y, theta, v
    acc0: object               # (A,)
    # peer plan-bank seed: bank0[i, j] = agent i's center (x, y, theta, v) at
    # global step j from its converted obstacle's recorded trajectory, or a
    # constant-velocity pseudo-plan when none exists
    bank0: object              # (A, W, 4)
    bank_len0: object          # (A,) int32 readable entries
    # the in-run behavior FSM (behavior.device_fsm); None without it
    fsm: object = None         # FSMTensors
    fsm_carry0: object = None  # FSMCarry
    # the responsibility term: the scenario's lanelets (LaneletTensors)
    lane: object = None
    # the visible-area sensor stage (prediction.calc_occlusions)
    road_segs: object = None       # (Sr, 2, 2) road-boundary walls
    cur_half: object = None        # (C, O, 2) raw half sizes per window row
    # the occlusion module's spawn locator (`_occlusion_spawn_tensors`)
    occ_obst: object = None        # (C, Oc, 3) recorded poses of every obstacle
    occ_obst_valid: object = None  # (C, Oc)
    occ_is_dyn: object = None      # (Oc,)
    occ_half: object = None        # (Oc,) max(length, width) / 2
    occ_cat_ok: object = None      # (Oc,) the obstacle's spawn category is on
    turn_xy: object = None         # (A, R2, 2) route vertices
    turn_spawn: object = None      # (A, R2, 2) turn spawn point per vertex
    turn_heading: object = None    # (A, R2)
    turn_hot: object = None        # (A, R2) |κ| above the threshold

    def to(self, device, dtype) -> "SimTensors":
        """The same structure as fresh tensors on `device` (never views of
        the host arrays: a runner loads other inputs into them): floats as
        `dtype`, masks bool, counters int32."""
        def leaf(a):
            a = np.require(a, requirements="C")     # keeps a 0-d leaf 0-d
            if a.dtype.kind == "f":
                return torch.tensor(a, dtype=dtype, device=device)
            return torch.tensor(a, device=device)

        return _map_leaves(leaf, self)


def _map_leaves(fn, first: SimTensors, *rest: SimTensors) -> SimTensors:
    """`fn` over the corresponding leaves of one or more SimTensors (absent
    options stay None)."""
    out = {}
    for f in fields(SimTensors):
        vals = [getattr(t, f.name) for t in (first, *rest)]
        if vals[0] is None:
            out[f.name] = None
        elif f.name in ("ref", "lane"):
            out[f.name] = type(vals[0])(*(fn(*xs) for xs in zip(*vals)))
        elif f.name in ("fsm", "fsm_carry0"):
            out[f.name] = vals[0].map(fn, *vals[1:])
        elif f.name == "pred_windows":
            out[f.name] = {k: fn(*(v[k] for v in vals)) for k in vals[0]}
        else:
            out[f.name] = fn(*vals)
    return SimTensors(**out)


@dataclass
class DeviceSimResult:
    """Host-side result of one device-resident run (single fetch)."""

    agent_ids: list
    status: np.ndarray            # (A,) AgentStatus ints (TIMELIMIT applied)
    steps: int                    # executed global steps (host loop parity)
    trajectories: np.ndarray      # (T, A, 5): center x, y, theta, v, a
    status_per_step: np.ndarray   # (T, A)
    selections: np.ndarray        # (C, A, 3): chosen (t1, ss1_target, d1)
    found: np.ndarray             # (C, A) bool
    costs: np.ndarray             # (C, A): the chosen candidate's cost
    wall_time: float = 0.0
    extras: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# host tensors
# ---------------------------------------------------------------------------


def _goal_tensors(agents, dtype):
    """Every agent's goal test as fixed-shape arrays (`Agent.goal_reached`):
    per goal, (position in any ring) and (velocity in its interval); rings
    are the goal lanelets' polygons and the goal's position shape; a goal
    without rings is a velocity-only goal."""
    ring_lists = []     # per agent: list[(ring (E, 2), vlo, vhi)]
    velonly = []        # per agent: (has, lo, hi)
    for a in agents:
        rows = []
        vo = (False, -np.inf, np.inf)
        for g in a.problem.goals:
            vlo, vhi = (-np.inf, np.inf)
            if g.velocity_interval is not None:
                vlo, vhi = g.velocity_interval
            rings = [a.scenario.lanelets[lid].polygon
                     for lid in g.position_lanelets if lid in a.scenario.lanelets]
            if g.position_shape is not None:
                rings.append(g.position_shape)
            if rings:
                rows.extend((np.asarray(r, float), vlo, vhi) for r in rings)
            else:
                vo = (True, vlo, vhi)
        ring_lists.append(rows)
        velonly.append(vo)

    g_max = max((len(r) for r in ring_lists), default=0) or 1
    e_max = max((len(ring) for rows in ring_lists for ring, _, _ in rows),
                default=0) or 3
    a_n = len(agents)
    rings = np.zeros((a_n, g_max, e_max, 2), dtype)
    ring_valid = np.zeros((a_n, g_max), bool)
    ring_v = np.zeros((a_n, g_max, 2), dtype)
    ring_v[..., 0], ring_v[..., 1] = -1e30, 1e30
    for i, rows in enumerate(ring_lists):
        for j, (ring, vlo, vhi) in enumerate(rows):
            # padded by repeating the last vertex: degenerate edges add no
            # crossings and the closing edge stays last → first
            e = len(ring)
            rings[i, j, :e] = ring
            rings[i, j, e:] = ring[-1]
            ring_valid[i, j] = True
            ring_v[i, j] = (max(vlo, -1e30), min(vhi, 1e30))
    vo_has = np.array([v[0] for v in velonly])
    vo_int = np.array([[max(v[1], -1e30), min(v[2], 1e30)] for v in velonly], dtype)
    return rings, ring_valid, ring_v, vo_has, vo_int


def _velocity_goal_tensors(agents, dtype):
    """Static inputs of the simulation's velocity planner
    (`Agent.desired_velocity`)."""
    a_n = len(agents)
    goal_s = np.zeros(a_n, dtype)
    has_goal_s = np.zeros(a_n, bool)
    goal_t_hi = np.zeros(a_n, dtype)
    has_goal_t = np.zeros(a_n, bool)
    goal_v_mean = np.zeros(a_n, dtype)
    for i, a in enumerate(agents):
        if a._goal_s is not None:
            goal_s[i] = a._goal_s
            has_goal_s[i] = True
        if a._goal_time is not None:
            goal_t_hi[i] = a._goal_time[1]
            has_goal_t[i] = True
        for g in a.problem.goals:
            if g.velocity_interval is not None:
                lo, hi = g.velocity_interval
                goal_v_mean[i] = max(0.0, (lo + hi) / 2.0)
                break
    return goal_s, has_goal_s, goal_t_hi, has_goal_t, goal_v_mean


def _obstacle_step_poses(scenario, agent_obstacle_ids, n_steps_total, dtype):
    """(T+1, O, 3) poses, (T+1, O) valid and (O, 2) half sizes of every
    scenario obstacle that is no agent (the side of `_check_collisions`)."""
    obs = [ob for ob in scenario.obstacles.values()
           if ob.obstacle_id not in agent_obstacle_ids]
    o_n = len(obs) or 1
    poses = np.zeros((n_steps_total + 1, o_n, 3), dtype)
    valid = np.zeros((n_steps_total + 1, o_n), bool)
    half = np.zeros((o_n, 2), dtype)
    for j, ob in enumerate(obs):
        half[j] = (ob.length / 2.0, ob.width / 2.0)
        for t in range(n_steps_total + 1):
            st = ob.state_at_time(t)
            if st is None:
                continue
            poses[t, j, :2] = st.position
            poses[t, j, 2] = st.orientation
            valid[t, j] = True
    return poses, valid, half


def _occlusion_spawn_tensors(sim, agents, n_cycles, k_replan, dtype):
    """The inputs of the run's occlusion spawn locator (`phantom_rows`).

    `OcclusionModule.find_spawn_points` walks every scenario obstacle at the
    replan step, agents' converted obstacles included, with their recorded
    states, so the per-cycle poses are known at set-up; only the ego position
    is live.  The turn spawn candidates (`_turn_spawn_points`) depend on the
    route alone, apart from which one is nearest the ego."""
    occ_cfg = sim.config.occlusion
    obs = list(sim.scenario.obstacles.values())
    oc_n = len(obs) or 1
    poses = np.zeros((n_cycles, oc_n, 3), dtype)
    valid = np.zeros((n_cycles, oc_n), bool)
    for c in range(n_cycles):
        t_c = c * k_replan
        for j, ob in enumerate(obs):
            st = ob.state_at_time(t_c)
            if st is None:
                continue
            poses[c, j, :2] = st.position
            poses[c, j, 2] = st.orientation
            valid[c, j] = True
    is_dyn = np.array([getattr(ob, "role", "dynamic") == "dynamic"
                       for ob in obs] or [False])
    half = np.array([max(ob.length, ob.width) / 2.0 for ob in obs] or [1.0], dtype)
    # the spawn categories fold into one flag per obstacle
    cat_ok = np.where(is_dyn, bool(occ_cfg.spawn_point_behind_dynamic_obstacle),
                      bool(occ_cfg.spawn_point_behind_static_obstacle))

    # per agent: every route vertex's turn spawn point (the host takes the
    # nearest high-curvature vertex ahead at plan time)
    r2_max = 1
    rows = []
    for a in agents:
        xy = None
        if a.occlusion is not None and occ_cfg.spawn_points_behind_turn:
            xy = a.occlusion.route_xy
        if xy is None or len(xy) < 5:
            rows.append(None)
            continue
        xy = np.asarray(xy, dtype=float)
        seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        dx, dy = np.gradient(xy[:, 0], s), np.gradient(xy[:, 1], s)
        ddx, ddy = np.gradient(dx, s), np.gradient(dy, s)
        kappa = (dx * ddy - dy * ddx) / np.maximum((dx * dx + dy * dy) ** 1.5, 1e-12)
        hot = np.abs(kappa) > 0.03          # the host's kappa_threshold
        spawn = np.zeros_like(xy)
        heading = np.zeros(len(xy))
        for i in np.where(hot)[0]:
            normal = np.array([-dy[i], dx[i]])
            normal /= max(np.linalg.norm(normal), 1e-9)
            inside = normal * np.sign(kappa[i])
            spawn[i] = xy[i] + 3.6 * inside
            heading[i] = float(np.arctan2(-inside[1], -inside[0]))
        rows.append((xy, spawn, heading, hot))
        r2_max = max(r2_max, len(xy))
    a_n = len(agents)
    turn_xy = np.zeros((a_n, r2_max, 2), dtype)
    turn_spawn = np.zeros((a_n, r2_max, 2), dtype)
    turn_heading = np.zeros((a_n, r2_max), dtype)
    turn_hot = np.zeros((a_n, r2_max), bool)
    for i, row in enumerate(rows):
        if row is None:
            continue
        xy, spawn, heading, hot = row
        n = len(xy)
        turn_xy[i, :n] = xy
        turn_xy[i, n:] = xy[-1]             # inert padding: hot stays False
        turn_spawn[i, :n] = spawn
        turn_heading[i, :n] = heading
        turn_hot[i, :n] = hot
    return dict(occ_obst=poses, occ_obst_valid=valid, occ_is_dyn=is_dyn,
                occ_half=half, occ_cat_ok=cat_ok, turn_xy=turn_xy,
                turn_spawn=turn_spawn, turn_heading=turn_heading, turn_hot=turn_hot)


def _kept_slots(*tensors: SimTensors) -> np.ndarray:
    """The window slots valid at some cycle of some input set, in order (at
    least one): the only prediction-window slots the run needs.

    Dropping the others is exact: every reduction over the obstacle axis of
    the cycle, the risk stack and the post-passes is a fixed-order sum to
    which an invalid slot adds an exact zero, or a masked maximum."""
    used = None
    for g in tensors:
        v = np.asarray(g.pred_windows["valid"])             # (..., C, O, H)
        u = v.reshape((-1,) + v.shape[-2:]).any(axis=(0, 2))
        used = u if used is None else used | u
    keep = np.flatnonzero(used)
    return keep if keep.size else np.zeros(1, np.int64)


def _trim_slots(g: SimTensors, keep: np.ndarray) -> SimTensors:
    """`g` with only the window slots `keep` (`_kept_slots`); the
    occluders, the collision sweep's obstacles and the spawn tensors stay
    whole.  A `g` of len(keep) slots is returned as it is: it is trimmed
    already, or `keep` is every one of its slots."""
    axis = np.ndim(g.x_cl0) - 2 + 1         # after the leading and cycle axes
    if np.shape(g.pred_windows["valid"])[axis] == len(keep):
        return g

    def take(x):
        return None if x is None else np.take(x, keep, axis=axis)

    return dataclasses.replace(
        g, pred_windows={k: take(v) for k, v in g.pred_windows.items()},
        cur_obst=take(g.cur_obst), cur_obst_valid=take(g.cur_obst_valid),
        cur_half=take(g.cur_half))


# ---------------------------------------------------------------------------
# device functions (any leading scenario axes ride along)
# ---------------------------------------------------------------------------


def goal_check(g: SimTensors, center, vel):
    """`Agent.goal_reached` for all agents: (..., A) bool from the centers
    (..., A, 2) and velocities (..., A).  The ring test is the crossing-number
    test of `io.commonroad._point_in_ring`."""
    a = g.g_rings                                      # (..., A, G, E, 2)
    b = torch.roll(g.g_rings, -1, dims=-2)
    p = center[..., None, None, :]                     # (..., A, 1, 1, 2)
    cond = (a[..., 1] > p[..., 1]) != (b[..., 1] > p[..., 1])
    den = b[..., 1] - a[..., 1]
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    x_int = a[..., 0] + (p[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0]) / den
    crossings = torch.sum(cond & (p[..., 0] < x_int), dim=-1)        # (..., A, G)
    inside = (crossings % 2).bool() & g.g_ring_valid
    vel_ok = ((vel[..., None] >= g.g_ring_v[..., 0])
              & (vel[..., None] <= g.g_ring_v[..., 1]))
    pos_goal = torch.any(inside & vel_ok, dim=-1)
    vo_ok = (g.g_vo_has & (vel >= g.g_vo_int[..., 0]) & (vel <= g.g_vo_int[..., 1]))
    return pos_goal | vo_ok


def desired_velocity(g: SimTensors, x_cl, v_cur, t_step, dt: float):
    """`Agent.desired_velocity` for all agents; `t_step` is the global step
    as a tensor of the working type."""
    dist = g.goal_s - x_cl[..., 0]
    rem_t = (g.goal_t_hi - t_step) * dt
    rem_d = torch.clamp(dist, min=0.0) / torch.clamp(v_cur, min=1.0)
    remaining = torch.where(g.has_goal_t, rem_t, rem_d)
    safe_rem = torch.where(remaining == 0.0, torch.ones_like(remaining), remaining)
    v = torch.clamp(dist / safe_rem, min=torch.clamp(v_cur - 5.0, min=0.0),
                    max=v_cur + 5.0)
    v = torch.where(remaining <= 0.0, torch.clamp(v_cur, min=1.0), v)
    v = torch.where(dist <= 2.0, g.goal_v_mean, v)
    return torch.where(g.has_goal_s, v, v_cur)


def _linspace64(lo, hi, n: int):
    """`np.linspace(lo, hi, n)` on float64 tensors (...,) → (..., n), by
    NumPy's own algorithm: arange · step + start, end point pinned."""
    step = (hi - lo) / (n - 1)
    grid = torch.arange(n, dtype=torch.float64, device=lo.device) * step[..., None] \
        + lo[..., None]
    grid[..., -1] = hi
    return grid


def build_sampling_matrices(x_cl, v_cur, t_grid, n_v: int, n_d: int, *, veh,
                            horizon: float, d_min: float, d_max: float,
                            d_ego_pos: bool):
    """Per-agent sampling matrix of one densification level, (..., A, M, 13),
    built on the device (`ReactivePlanner._sampling_ranges` +
    `ops.sampling.build_sampling_matrix`).

    `t_grid` (nt,) is the level's static end-time grid.  The velocity grid
    comes from the current velocity and the lateral grid from the config (or
    the current d with `d_ego_pos`), both as the host computes them: in
    float64 by `np.linspace`'s algorithm, cast once to the working type.  The
    current ṡ and d are appended where the host unions them in, so a value
    already on a grid gives duplicate rows: identical candidates.  Rows vary
    d fastest, then v, then t."""
    dtype = x_cl.dtype
    lead = tuple(x_cl.shape[:-1])                        # (..., A)
    s0, ss0, sss0, d0, dd0, ddd0 = (x_cl[..., i] for i in range(6))
    v64 = v_cur.double()
    v_lo = torch.clamp(v64 - veh.a_max * horizon, min=0.001)
    v_hi = torch.clamp(v64 + (veh.a_max / 6.0) * horizon, max=veh.v_max)
    vs = torch.cat([_linspace64(v_lo, v_hi, n_v).to(dtype), ss0[..., None]], dim=-1)
    if d_ego_pos:
        # the host adds the bounds to its current d in the working type
        d_lo, d_hi = (d0 + d_min).double(), (d0 + d_max).double()
    else:
        d_lo, d_hi = torch.full_like(v64, d_min), torch.full_like(v64, d_max)
    ds = torch.cat([_linspace64(d_lo, d_hi, n_d).to(dtype), d0[..., None]], dim=-1)
    t_n, v_n, d_n = t_grid.shape[0], n_v + 1, n_d + 1
    grid = lead + (t_n, v_n, d_n)
    rows = lead + (t_n * v_n * d_n,)

    def col(x):
        return x.expand(grid).reshape(rows)

    def pin(x):
        return x[..., None].expand(rows)

    zero = torch.zeros(rows, dtype=dtype, device=x_cl.device)
    return torch.stack([
        zero, col(t_grid[:, None, None]), pin(s0), pin(ss0), pin(sss0),
        col(vs[..., None, :, None]), zero, pin(d0), pin(dd0), pin(ddd0),
        col(ds[..., None, None, :]), zero, zero], dim=-1)


def _rank(col):
    """Per row of (..., M), the number of strictly smaller entries; equal
    values share a rank."""
    return torch.searchsorted(torch.sort(col, dim=-1).values, col.contiguous())


def stopping_rank_key(matrix, d0):
    """The "stopping" fallback's order as one integer key per candidate:
    (rank(v)·M + rank(t))·M + rank(|d − d0|), v = column 5, t = column 1,
    d = column 10 (`ReactivePlanner._select_stopping_index`: v ascending,
    then t, then the distance of d from the current d).  int64: the key
    passes 2^31 from M = 1291 on."""
    m = matrix.shape[-2]
    v, t = matrix[..., 5], matrix[..., 1]
    d = torch.abs(matrix[..., 10] - d0[..., None])
    return (_rank(v) * m + _rank(t)) * m + _rank(d)


def _gather_rows(x, idx):
    """x (..., M, W) at candidate idx (...,) → (..., W)."""
    w = x.shape[-1]
    return torch.gather(x, -2, idx[..., None, None].expand(idx.shape + (1, w)))[..., 0, :]


def select_with_fallback(res, matrix, mask, d0, emergency: str, risks=None,
                         emit_margins: bool = False):
    """The cycle's selection, or the emergency ladder's when no candidate is
    selectable (`ReactivePlanner.plan`): with "stopping" the first feasible
    candidate in the order of `stopping_rank_key`, with "min_risk" the
    feasible candidate of lowest ego + obstacle risk; first index on ties.
    Returns the selected candidate's state rows (..., N+1), `found`, `fb_ok`
    (the ladder had a feasible candidate), `best`, `sel` (t1, ṡ1, d1) and
    `cost` (its cost).

    With `emit_margins` also the selection's knife edge, from the program's
    own masked cost vector: `margin_gap` (second best − best, inf with fewer
    than two selectable candidates) and `margin_rel` (the gap over
    max(|best|, 1e-12); NaN where nothing is selectable), as the JAX
    package's `_build_run(emit_margins=True)`."""
    ro = res.rollout
    feas = ro.feasible & ro.valid & mask
    if emergency == "min_risk":
        total = risks.ego_risk + risks.obst_risk
        key = torch.where(feas, total, torch.full_like(total, torch.inf))
    else:
        key = stopping_rank_key(matrix, d0)
        key = torch.where(feas, key, torch.full_like(key, torch.iinfo(torch.int64).max))
    fb_idx = torch.argmin(key, dim=-1)
    idx = torch.where(res.found, res.best_idx.long(), fb_idx)
    out = {key_: _gather_rows(getattr(ro, attr), idx) for attr, key_ in _SEL_FIELDS}
    params = _gather_rows(matrix, idx)
    out.update(found=res.found, fb_ok=torch.any(feas, dim=-1), best=idx,
               sel=torch.stack([params[..., 1], params[..., 5], params[..., 10]],
                               dim=-1),
               cost=torch.gather(res.cost, -1, idx[..., None])[..., 0])
    if emit_margins:
        inf = torch.full_like(res.cost, torch.inf)
        top2 = -torch.topk(-torch.where(res.selectable, res.cost, inf), 2, dim=-1).values
        best, second = top2[..., 0], top2[..., 1]
        gap = torch.where(torch.isfinite(second), second - best, inf[..., 0])
        out["margin_gap"] = gap
        out["margin_rel"] = gap / torch.clamp(torch.abs(best), min=1e-12)
    return out


def _merge(take_b, a: dict, b: dict) -> dict:
    """Per agent, b's entries where `take_b` (..., A), else a's."""
    return {k: torch.where(take_b.reshape(take_b.shape + (1,) * (a[k].dim()
                                                                 - take_b.dim())),
                           b[k], a[k]) for k in a}


def build_stop_matrices(x_cl, stop_s, stop_v, t_grid, n_s: int, n_d: int):
    """The quintic stopping matrix of every agent, (..., A, M, 13)
    (`ReactivePlanner._stopping_matrix` at the first sampling level, the
    only one the host tries): t1 × n_s end positions from halfway to the
    stop point × (n_d + 1) end offsets around the current d, end velocity 0.

    The grids are computed in float64 by `np.linspace`'s algorithm and cast
    once, as the host does.  Where d0 falls on the lateral grid the host's
    `union1d` drops the duplicate; here it stays, an identical candidate."""
    dtype = x_cl.dtype
    lead = tuple(x_cl.shape[:-1])
    s0, ss0, sss0, d0, dd0, ddd0 = (x_cl[..., i] for i in range(6))
    s0_64, ss0_64, d0_64 = s0.double(), ss0.double(), d0.double()
    stop_64 = stop_s.double()
    ref_vel = (ss0_64 + stop_v.double()) / 2.0
    d_delta = torch.where(ref_vel < 5.0, torch.clamp((ss0_64 / 5.0) * 0.4, min=0.01),
                          torch.full_like(ref_vel, 0.4))
    s1 = _linspace64((s0_64 + stop_64) / 2.0, stop_64, n_s).to(dtype)
    d1 = torch.sort(torch.cat([_linspace64(d0_64 - d_delta, d0_64 + d_delta, n_d),
                               d0_64[..., None]], dim=-1), dim=-1).values.to(dtype)
    t_n, d_n = t_grid.shape[0], n_d + 1
    grid = lead + (t_n, n_s, d_n)
    rows = lead + (t_n * n_s * d_n,)

    def col(x):
        return x.expand(grid).reshape(rows)

    def pin(x):
        return x[..., None].expand(rows)

    zero = torch.zeros(rows, dtype=dtype, device=x_cl.device)
    return torch.stack([
        zero, col(t_grid[:, None, None]), pin(s0), pin(ss0), pin(sss0),
        col(s1[..., None, :, None]), zero, pin(d0), pin(dd0), pin(ddd0),
        col(d1[..., None, None, :]), zero, zero], dim=-1)


def benign_stop_row(x_cl, *, n_steps: int, dt: float, horizon: float):
    """(..., A, 13): the row that stands in for every masked row of a
    stopping matrix.  Masked rows still go through the quintic solve, so
    they must be well conditioned: end time the horizon, end position at
    least a second of travel ahead, the current d."""
    s0, ss0, d0 = x_cl[..., 0], x_cl[..., 1], x_cl[..., 3]
    zero = torch.zeros_like(s0)
    return torch.stack([
        zero, torch.full_like(s0, n_steps * dt), s0, ss0, x_cl[..., 2],
        s0 + torch.clamp(ss0, min=1.0) * horizon, zero, d0, x_cl[..., 4],
        x_cl[..., 5], d0, zero, zero], dim=-1)


def _repeat_last(x, k: int):
    """Each entry of the last axis k times in a row (`repeat_interleave` by
    expand: no count tensor, no host copy)."""
    return x[..., None].expand(x.shape + (k,)).flatten(-2)


def occluder_segments(obst_pose, obst_valid, obst_half, center, theta, h_agent,
                      running_pre, eye):
    """The occluding edges of one cycle: the scenario obstacles' boxes at the
    replan step (..., O' · 4, 2, 2) and the live peers' (..., A · 4, 2, 2),
    with each agent's validity (..., A, O' · 4) and (..., A, A · 4): an
    agent is no occluder of itself, and a peer only while it runs."""
    segs_o = obb_segments_batch(obst_pose[..., :2], obst_pose[..., 2], obst_half)
    segs_p = obb_segments_batch(center, theta, h_agent.expand(center.shape))
    lead_a = tuple(center.shape[:-1])                           # (..., A)
    o4 = _repeat_last(obst_valid, 4)                            # (..., O'·4)
    o4 = o4[..., None, :].expand(lead_a + o4.shape[-1:])
    peer_ok = running_pre[..., None, :] & ~eye                  # (..., A, A)
    return (segs_o.flatten(-4, -3), segs_p.flatten(-4, -3), o4,
            _repeat_last(peer_ok, 4))


def visible_window_rows(center, r_vis, cur, cur_half):
    """The visible-area membership of the window rows (`VisibleArea.
    obstacle_visible`): a row is visible when one of its 4 corners or its
    center lies within its ray's range + 0.3 m.  center (..., A, 2), r_vis
    (..., A, K), cur (..., O, 3), cur_half (..., O, 2) → (..., A, O)."""
    corners = obb_segments_batch(cur[..., :2], cur[..., 2], cur_half)[..., :, 0, :]
    probes = torch.cat([corners, cur[..., None, :2]], dim=-2)  # (..., O, 5, 2)
    rel = probes[..., None, :, :, :] - center[..., :, None, None, :]  # (..., A, O, 5, 2)
    rr = torch.linalg.norm(rel, dim=-1)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    k_rays = r_vis.shape[-1]
    # the nearest ray, ties rounded to even as `VisibleArea.r_at` does
    idx = torch.round((ang + np.pi) / (2 * np.pi) * k_rays).long() % k_rays
    r_at = torch.gather(r_vis[..., None, :].expand(idx.shape[:-1] + (k_rays,)), -1, idx)
    return torch.any(rr <= r_at + 0.3, dim=-1)


def phantom_rows(ego, n_free, occ_obst, occ_valid, occ_is_dyn, occ_half, occ_cat_ok,
                 turn_xy, turn_spawn, turn_heading, turn_hot, *, horizon: int,
                 dt: float, sensor_radius: float, max_phantoms: int,
                 max_dynamic: int, max_static: int, use_turn: bool,
                 velocity: float, var_factor: float, length: float, width: float):
    """The occlusion module's phantoms of every agent at once
    (`OcclusionModule.find_spawn_points`, `_turn_spawn_points`,
    `phantom_prediction_rows` and `augment_predictions`' free-slot cap).

    Spawn candidates: the two silhouette-edge points of every obstacle
    within [2 m, sensor radius] of the ego (side +1 first), then the nearest
    hot route vertex ahead.  The host sorts each category by distance with
    Python's stable sort, keeps the per-category caps and then the nearest
    overall; here each candidate's rank under (distance, group, insertion
    order) reproduces that order.  Inputs: ego (..., A, 2), n_free (..., A),
    the cycle's occ_obst (..., Oc, 3) and occ_valid (..., Oc), the per-agent
    turn tensors (..., A, R2, ...).  Returns (PredictionTensors with
    (..., A, P, ...) leaves, admitted (..., A, P), spawn points (..., A, P, 2)),
    P = max_phantoms."""
    dtype, device = ego.dtype, ego.device
    pos = occ_obst[..., None, :, :2]                            # (..., 1, Oc, 2)
    d_vec = pos - ego[..., :, None, :]                          # (..., A, Oc, 2)
    dist_o = torch.hypot(d_vec[..., 0], d_vec[..., 1])
    ok_o = ((occ_valid & occ_cat_ok)[..., None, :] & (dist_o >= 2.0)
            & (dist_o <= sensor_radius))
    ray = d_vec / torch.clamp(dist_o, min=1e-9)[..., None]
    perp = torch.stack([-ray[..., 1], ray[..., 0]], dim=-1)
    reach = perp * (occ_half + 0.5)[..., None, :, None]
    sp_pos = torch.stack([pos + reach + ray * 1.0, pos - reach + ray * 1.0], dim=-2)
    sp_head = torch.stack([torch.atan2(-perp[..., 1], -perp[..., 0]),
                           torch.atan2(perp[..., 1], perp[..., 0])], dim=-1)
    cand_pos = sp_pos.flatten(-3, -2)                           # (..., A, 2·Oc, 2)
    cand_head = sp_head.flatten(-2, -1)
    cand_dist = _repeat_last(dist_o, 2)
    cand_ok = _repeat_last(ok_o, 2)
    cand_grp = _repeat_last(torch.where(occ_is_dyn, 0, 1), 2)[..., None, :].expand(
        cand_ok.shape)

    # the turn candidate (at most one, last)
    dist_t = torch.hypot(turn_xy[..., 0] - ego[..., 0, None],
                         turn_xy[..., 1] - ego[..., 1, None])   # (..., A, R2)
    cand_t = (dist_t > 5.0) & (dist_t < sensor_radius) & turn_hot
    has_t = torch.any(cand_t, dim=-1)
    if not use_turn:
        has_t = torch.zeros_like(has_t)
    i_t = torch.argmin(torch.where(cand_t, dist_t, torch.full_like(dist_t, torch.inf)),
                       dim=-1)[..., None]                       # (..., A, 1)
    pos_all = torch.cat([cand_pos, torch.gather(
        turn_spawn, -2, i_t[..., None].expand(i_t.shape + (2,)))], dim=-2)
    head_all = torch.cat([cand_head, torch.gather(turn_heading, -1, i_t)], dim=-1)
    dist_all = torch.cat([cand_dist, torch.gather(dist_t, -1, i_t)], dim=-1)
    ok_all = torch.cat([cand_ok, has_t[..., None]], dim=-1)
    grp = torch.cat([cand_grp, torch.full_like(cand_grp[..., :1], 2)], dim=-1)
    n = ok_all.shape[-1]
    ins = torch.arange(n, device=device)

    def precedes(mask_j):
        """(..., A, N, N): candidate j (last axis) comes before candidate i
        under (distance, group, insertion), restricted to mask_j."""
        dj, di = dist_all[..., None, :], dist_all[..., :, None]
        gj, gi = grp[..., None, :], grp[..., :, None]
        less = (dj < di) | ((dj == di) & ((gj < gi) | ((gj == gi)
                                                     & (ins[None, :] < ins[:, None]))))
        return less & mask_j[..., None, :]

    is_dyn, is_stat = grp == 0, grp == 1
    rank_dyn = torch.sum(precedes(ok_all & is_dyn), dim=-1)
    rank_stat = torch.sum(precedes(ok_all & is_stat), dim=-1)
    kept = ok_all & ((is_dyn & (rank_dyn < max_dynamic))
                     | (is_stat & (rank_stat < max_static)) | (grp == 2))
    rank_all = torch.sum(precedes(kept), dim=-1)
    n_adm = torch.clamp(n_free, min=0, max=max_phantoms)
    admitted = kept & (rank_all < n_adm[..., None])

    # the first P admitted candidates in rank order
    p_idx = torch.arange(max_phantoms, device=device)
    match = admitted[..., None, :] & (rank_all[..., None, :] == p_idx[:, None])
    row_i = torch.argmax(match.to(torch.uint8), dim=-1)         # (..., A, P)
    row_ok = torch.any(match, dim=-1)
    row_pos = torch.gather(pos_all, -2, row_i[..., None].expand(row_i.shape + (2,)))
    row_head = torch.gather(head_all, -1, row_i)

    # constant velocity along the heading, inflated variance
    vel = float(velocity)
    steps = torch.arange(1, horizon + 1, dtype=dtype, device=device)
    hvec = torch.stack([torch.cos(row_head), torch.sin(row_head)], dim=-1)
    means = row_pos[..., None, :] + (vel * dt * steps)[:, None] * hvec[..., None, :]
    var = (0.3 + 0.2 * steps * dt) * var_factor                # (H,)
    eye = torch.eye(2, dtype=dtype, device=device)
    lead = tuple(row_head.shape)                                # (..., A, P)
    covs = (eye * var[:, None, None]).expand(lead + (horizon, 2, 2))
    inv = (eye * (1.0 / var)[:, None, None]).expand(lead + (horizon, 2, 2))
    preds = PredictionTensors(
        means=means, inv_covs=inv, covs=covs,
        orientations=row_head[..., None].expand(lead + (horizon,)),
        velocities=torch.full(lead + (horizon,), vel, dtype=dtype, device=device),
        lengths=torch.full(lead, length, dtype=dtype, device=device),
        widths=torch.full(lead, width, dtype=dtype, device=device),
        valid=row_ok[..., None].expand(lead + (horizon,)))
    return preds, row_ok, row_pos


def reach_grids(preds: PredictionTensors, lane, n_lead: int):
    """Every agent's reach-set grids from its prediction rows' first step
    (`build_reach_set_grids_device`), (..., A, O, ...) leaves.  A fleet's
    lanelet leaves carry the scenario axis (`n_lead` = 1): each row is
    rasterized on its own member's map."""
    pos = preds.means[..., 0, :]                                # (..., A, O, 2)
    rows = tuple(pos.shape[:-1])
    if n_lead:
        per = int(np.prod(rows[n_lead:]))
        lane = type(lane)(*(x.reshape(x.shape[:n_lead] + (1,) + x.shape[n_lead:])
                            .expand(x.shape[:n_lead] + (per,) + x.shape[n_lead:])
                            .flatten(0, n_lead) for x in lane))
    grid = build_reach_set_grids_device(
        pos.reshape(-1, 2), preds.orientations[..., 0].reshape(-1),
        preds.velocities[..., 0].reshape(-1), preds.lengths.reshape(-1),
        preds.widths.reshape(-1), preds.valid[..., 0].reshape(-1), lane)
    return grid._replace(
        origin=grid.origin.reshape(rows + (2,)),
        occupancy=grid.occupancy.reshape(rows + grid.occupancy.shape[1:]),
        valid=grid.valid.reshape(rows), cell=grid.cell.reshape(rows))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class _Runner:
    """The body of the run over fixed buffers, eager or as a CUDA graph.

    `proto` gives the statics (config, levels, vehicle); `g_host` the inputs,
    whose leading axes before the agent axis (none, or the scenario axis) the
    body carries along.  With `g_host.fsm` the body runs the in-run behavior
    FSM and the stopping program; with `hybrid` it takes the behavior's
    velocities and stopping matrices from the input buffers `b_in` instead;
    with `hybrid_pred` its prediction rows from the input buffers `p_in`;
    with `emit_margins` it also writes every cycle's selection margins
    (`select_with_fallback`) into (C, ..., A) output buffers that the one
    fetch brings back.  `load` copies another input set of the same shapes
    into the input buffers (restacked tables), `take` an owner's inputs
    unless the buffers hold them (a shared runner's next scenario or
    fleet), `run` resets the carry, drives `n_cycles` cycles and fetches
    once.  `loaded` is the owner whose inputs the buffers hold: a
    DeviceSimulation, or a fleet's members as a tuple."""

    def __init__(self, proto: "DeviceSimulation", g_host: SimTensors, n_cycles: int,
                 hybrid: bool = False, hybrid_pred: bool = False, keep=None,
                 emit_margins: bool = False):
        self.p = proto
        self.device = proto.device
        self.dtype = proto.dtype
        self.n_cycles = int(n_cycles)
        # the window slots the buffers hold (`_kept_slots`; a fleet's chunks
        # pass the union over all members)
        self.keep = _kept_slots(g_host) if keep is None else keep
        self.g = g = _trim_slots(g_host, self.keep).to(self.device, self.dtype)
        self.lead = lead = tuple(g.x_cl0.shape[:-2])
        self.nl = len(lead)
        self.a_n = a_n = int(g.x_cl0.shape[-2])
        self.use_fsm = g.fsm is not None
        self.hybrid = bool(hybrid)
        dev, dtype = self.device, self.dtype
        k, c_n = proto.k_replan, self.n_cycles

        def buf(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.state = dict(
            x_cl=buf(lead + (a_n, 6)), center=buf(lead + (a_n, 2)),
            theta=buf(lead + (a_n,)), v=buf(lead + (a_n,)), acc=buf(lead + (a_n,)),
            status=buf(lead + (a_n,), torch.int32),
            bank=buf(tuple(g.bank0.shape)), bank_len=buf(lead + (a_n,), torch.int32),
            cycle=buf((1,), torch.int64),
        )
        self.fsm_state = None
        if self.use_fsm:
            # the WorldView presence rule: the last step each agent executed
            self.state["last_exec"] = buf(lead + (a_n,), torch.int32)
            self.fsm_state = g.fsm_carry0.map(torch.clone)
        self.b_in = None
        if self.hybrid:
            # the executed curvature and the orientation before the last
            # sub-step: the host mirrors' steering angle and yaw rate
            self.state["kap"] = buf(lead + (a_n,))
            self.state["th_prev"] = buf(lead + (a_n,))
            m_stop = proto.stop_bucket
            self.b_in = dict(
                v_des=buf(lead + (a_n,)), stop_mat=buf(lead + (a_n, m_stop, 13)),
                stop_mask=buf(lead + (a_n, m_stop), torch.bool),
                wants=buf(lead + (a_n,), torch.bool))
        self.p_in = None
        if hybrid_pred:
            # the host-built (A, O, H, ...) rows at the nominal width
            pc = proto.config.prediction
            rows = lead + (a_n, int(pc.max_obstacles))
            steps = rows + (int(pc.horizon_steps),)
            self.p_in = dict(
                means=buf(steps + (2,)), covs=buf(steps + (2, 2)),
                inv_covs=buf(steps + (2, 2)), orientations=buf(steps),
                velocities=buf(steps), lengths=buf(rows), widths=buf(rows),
                valid=buf(steps, torch.bool))
        self.out = dict(
            traj=buf((c_n,) + lead + (k, a_n, 5)),
            status_steps=buf((c_n,) + lead + (k, a_n), torch.int32),
            sel=buf((c_n,) + lead + (a_n, 3)),
            found=buf((c_n,) + lead + (a_n,), torch.bool),
            cost=buf((c_n,) + lead + (a_n,)),
            x_cl=buf((c_n,) + lead + (a_n, 6)),
        )
        self.emit_margins = bool(emit_margins)
        if self.emit_margins:
            for name in MARGINS:
                self.out[name] = buf((c_n,) + lead + (a_n,))
        veh = proto.veh
        self.h_agent = torch.as_tensor([veh.length / 2.0, veh.width / 2.0],
                                       dtype=dtype, device=dev)
        self.eye = torch.eye(a_n, dtype=torch.bool, device=dev)
        self.hold_cols = torch.as_tensor([True, False, False, True, False, False],
                                         device=dev)
        self.weights = torch.as_tensor(proto.weights_np, dtype=dtype, device=dev)
        self.t_grids = [torch.as_tensor(lvl[0], dtype=dtype, device=dev)
                        for lvl in proto.levels]
        self.masks = [torch.ones(lead + (a_n, lvl[3]), dtype=torch.bool, device=dev)
                      for lvl in proto.levels]
        self.graph = None         # the captured body (`_Graph`)
        self.capture_s = 0.0
        self.loaded = proto

    # ------------------------------------------------------------- buffers
    def _buffers(self) -> list:
        """Every buffer the body writes: state, FSM carry and outputs."""
        bufs = list(self.state.values()) + list(self.out.values())
        if self.fsm_state is not None:
            bufs += [getattr(self.fsm_state, f.name) for f in fields(self.fsm_state)]
        return bufs

    def load(self, g_host: SimTensors) -> None:
        """Copy another input set of the same shapes into the input buffers."""
        def copy(dst, src):
            src = torch.as_tensor(np.require(src, requirements="C"))
            if dst.shape != src.shape:
                raise ValueError(f"input of shape {tuple(src.shape)} does not fit "
                                 f"the run's buffer {tuple(dst.shape)}")
            dst.copy_(src)
            return dst

        _map_leaves(copy, self.g, _trim_slots(g_host, self.keep))

    def take(self, owner, inputs, span: str) -> None:
        """Make the buffers hold `owner`'s inputs: `inputs()` copied in
        (`load`, inside the host span `span`) unless they are there."""
        if self.loaded is owner:
            return
        with tracing.span(span):
            self.load(inputs())
        self.loaded = owner

    def reset(self) -> None:
        g, st = self.g, self.state
        st["x_cl"].copy_(g.x_cl0)
        st["center"].copy_(g.pose0[..., :2])
        st["theta"].copy_(g.pose0[..., 2])
        st["v"].copy_(g.pose0[..., 3])
        st["acc"].copy_(g.acc0)
        st["status"].copy_(torch.where(g.active0, _RUNNING, _ERROR))
        st["bank"].copy_(g.bank0)
        st["bank_len"].copy_(g.bank_len0)
        st["cycle"].zero_()
        if self.use_fsm:
            st["last_exec"].zero_()
            for f in fields(self.fsm_state):
                getattr(self.fsm_state, f.name).copy_(getattr(g.fsm_carry0, f.name))
        if self.hybrid:
            st["th_prev"].copy_(g.pose0[..., 2])

    # ---------------------------------------------------------------- body
    def _programs(self, matrix, mask, x_cl, v, ctx, post: dict, quintic: bool = False):
        """One sampling matrix for all agents, both kinematics modes merged
        per agent by the host's rule v < low_vel_mode_threshold; `post` holds
        the cycle's inputs of the post-passes (empty without them).  With a
        mesh this rank evaluates its agent rows and all-gathers the
        selection of every agent."""
        mesh = self.p.mesh
        if mesh is None:
            return self._programs_on(matrix, mask, x_cl, v, ctx, post, quintic)
        lo, hi = mesh_rows(mesh, x_cl.shape[0])
        return gather_rows(mesh, self._programs_on(
            matrix[lo:hi], mask[lo:hi], x_cl[lo:hi], v[lo:hi], agent_rows(ctx, lo, hi),
            {k: agent_rows(x, lo, hi) for k, x in post.items()}, quintic))

    def _programs_on(self, matrix, mask, x_cl, v, ctx, post: dict, quintic: bool):
        p = self.p
        d0 = x_cl[..., 3]
        outs = []
        for low_vel in (False, True):
            res = evaluate_cycle(
                matrix, mask, ctx, dt=p.dt, n_steps=p.n_steps, low_vel_mode=low_vel,
                quintic_lon=quintic, table_window=768,
                compensated_sum=p.compensated_sum)
            risks = None
            if p.need_risks:
                risks = trajectory_risks(
                    res.rollout, ctx.preds,
                    meta_from_footprint(ctx.preds.lengths, ctx.preds.widths),
                    p.veh.mass)
            if p.resp_weight != 0.0 or p.use_occlusion:
                # the post-passes in the batched host cycle's order, then one
                # argmin over what stays selectable
                cost, selectable, best, found = post_pass_selection(
                    res, ctx, risks, dt=p.dt, resp_weight=p.resp_weight,
                    grid=post.get("grid"), phantom_mask=post.get("pm"),
                    thresholds=p.thresholds, occ_pm_weight=p.occ_pm_weight,
                    occ_um_weight=p.occ_um_weight, occ_ve_weight=p.occ_ve_weight,
                    occ_geom=post.get("geom"))
                res = res._replace(cost=cost, best_idx=best, found=found,
                                   selectable=selectable)
            outs.append(select_with_fallback(res, matrix, mask, d0,
                                             p.emergency_mode, risks,
                                             emit_margins=self.emit_margins))
        return _merge(v < p.config.planning.low_vel_mode_threshold, outs[0], outs[1])

    def _cycle_all_agents(self, level: int, x_cl, v, ctx, post: dict):
        """One densification level for all agents."""
        p = self.p
        pl = p.config.planning
        t_grid, (_, n_v, n_d, _) = self.t_grids[level], p.levels[level]
        matrix = build_sampling_matrices(
            x_cl, v, t_grid, n_v, n_d, veh=p.veh, horizon=p.horizon,
            d_min=pl.d_min, d_max=pl.d_max, d_ego_pos=p.d_ego_pos)
        return self._programs(matrix, self.masks[level], x_cl, v, ctx, post)

    def step(self) -> None:
        """One replanning cycle of all agents: enqueues device work only."""
        p, g, st, nl, lead, a_n = self.p, self.g, self.state, self.nl, self.lead, self.a_n
        dtype = self.dtype
        veh = p.veh
        k, dt, n_steps = p.k_replan, p.dt, p.n_steps
        wb = veh.wb_rear_axle
        c = st["cycle"]                                   # (1,) int64
        x_cl, center, theta = st["x_cl"], st["center"], st["theta"]
        v, acc, status = st["v"], st["acc"], st["status"]
        bank, bank_len = st["bank"], st["bank_len"]
        max_steps = g.max_steps[..., None]                # (..., 1)

        def at(x, index):
            """x (..., T, ...) at time/cycle `index` (1,) on the device."""
            return torch.index_select(x, nl, index).squeeze(nl)

        t0 = c * k
        # --- goal check at the cycle's start state ---------------------------
        # every transition is gated on the member's OWN step budget: in a
        # fleet a member that ends TIMELIMIT alone must not change status in
        # the padding cycles
        in_horizon = t0 < max_steps
        running = status == _RUNNING
        # peers see one another by the statuses BEFORE this step's goal check
        # (the sequential host order): an agent that reaches its goal now is
        # still visible for this replan
        running_pre = running
        reached = goal_check(g, center, v) & running & in_horizon
        status = torch.where(reached, _SUCCESS, status)
        running = status == _RUNNING

        x_cl_replan = x_cl
        behavior = None
        if self.use_fsm:
            # the in-run behavior FSM: desired velocity and stop point as the
            # host behavior module computes them, then the stopping matrix of
            # the agents whose stop point asks for stopping mode
            # (`reactive.wants_stopping_mode`)
            peer_present = (st["last_exec"] == t0) & g.active0
            fsm_new, v_des, stop_s, stop_v = p.fsm_step(
                g.fsm, self.fsm_state, c, t0, center, theta, v, running, peer_present)
            thr = p.config.behavior.stopping_mode_threshold
            wants = (running & (stop_v < thr) & (stop_s > x_cl[..., 0])
                     & (stop_v < torch.clamp(x_cl[..., 1], min=1.0) + 2.0))
            stop_mat = build_stop_matrices(x_cl, stop_s, stop_v, self.t_grids[0],
                                           p.levels[0][1], p.stop_n_d)
            behavior = (stop_mat, wants[..., None].expand(stop_mat.shape[:-1]), wants)
        elif self.hybrid:
            # the host behavior modules' outputs of this cycle
            b = self.b_in
            v_des = b["v_des"]
            behavior = (b["stop_mat"], b["stop_mask"], b["wants"])
        else:
            v_des = desired_velocity(g, x_cl, v, t0.to(dtype), dt)

        # --- this cycle's predictions ----------------------------------------
        if self.p_in is not None:
            # the host's rows of this cycle (`DeviceSimulation._hybrid_pred_cycle`:
            # the net, the sensor filter, the peers and the eviction applied)
            preds, post = PredictionTensors(**self.p_in), {}
        else:
            preds, post = self._window_predictions(c, t0, center, theta, v, running_pre,
                                                   bank, bank_len)
        if p.resp_weight != 0.0:
            # the reach grids depend on the predictions alone: built once per
            # cycle for every program
            post["grid"] = reach_grids(preds, g.lane, nl)
        ctx = CycleContext(
            ref=g.ref, veh=veh, weights=self.weights, preds=preds,
            obstacle_xy=preds.means[..., 0, :], obstacle_valid=preds.valid[..., 0],
            corridor=g.corridors, lane_segments=g.lane_segments,
            lane_valid=g.lane_valid, x0_orientation=theta,
            desired_velocity=v_des, desired_avg_velocity=v_des)

        # --- progressive densification: every level runs, the first level
        # that found a candidate wins per agent; when none did, the LAST
        # level's ladder applies ------------------------------------------------
        out = self._cycle_all_agents(0, x_cl, v, ctx, post)
        for level in range(1, len(p.levels)):
            out = _merge(~out["found"], out,
                         self._cycle_all_agents(level, x_cl, v, ctx, post))
        if behavior is not None:
            # stopping mode: the host tries the stopping matrix first (at the
            # first level only) and samples regularly when it finds nothing,
            # so its result wins where the agent wants it and it found one
            stop_mat, stop_mask, wants = behavior
            benign = benign_stop_row(x_cl, n_steps=n_steps, dt=dt, horizon=p.horizon)
            stop_mat = torch.where(stop_mask[..., None], stop_mat, benign[..., None, :])
            out_stop = self._programs(stop_mat, stop_mask, x_cl, v, ctx, post,
                                      quintic=True)
            out = _merge(wants & out_stop["found"], out, out_stop)
        found = out["found"]
        # the emergency ladder: standstill at v <= 0.1 first, then the
        # fallback selection, else the agent fails
        std = running & ~found & (v <= 0.1)
        fail = running & ~found & ~std & ~out["fb_ok"] & in_horizon
        status = torch.where(fail, _ERROR, status)
        running = status == _RUNNING

        # --- publish this cycle's plans into the peer bank -------------------
        # (a standstill agent publishes a constant pose with v = 0)
        plan_th = out["theta"]                                        # (..., A, N+1)
        bank_plan = torch.stack([
            out["x"] + wb * torch.cos(plan_th), out["y"] + wb * torch.sin(plan_th),
            plan_th, out["v"]], dim=-1)                               # (..., A, N+1, 4)
        w_bank = bank.shape[-2]
        if w_bank > bank_plan.shape[-2]:
            pad = bank_plan[..., -1:, :].expand(
                lead + (a_n, w_bank - bank_plan.shape[-2], 4))
            bank_plan = torch.cat([bank_plan, pad], dim=-2)
        std_row = torch.cat([center, theta[..., None], torch.zeros_like(v)[..., None]],
                            dim=-1)                                   # (..., A, 4)
        bank = torch.where(std[..., None, None],
                           std_row[..., None, :].expand(bank.shape),
                           bank_plan[..., :w_bank, :])
        bank_len = torch.full_like(bank_len, n_steps + 1)

        # --- execute k sub-steps with the status ladder ----------------------
        last_exec = st.get("last_exec")
        kap, th_prev = st.get("kap"), st.get("th_prev")
        traj_steps, status_steps = [], []
        for j in range(1, k + 1):
            t_glob = t0 + j
            if j > 1:
                reached = goal_check(g, center, v) & running & (t_glob <= max_steps)
                status = torch.where(reached, _SUCCESS, status)
                running = status == _RUNNING
            step_ok = running & (t_glob <= max_steps)
            if last_exec is not None:
                # an agent "has a state at t" iff it executed step t (the
                # colliding state included)
                last_exec = torch.where(step_ok, t_glob.to(torch.int32), last_exec)
            mov = step_ok & ~std
            hold = step_ok & std
            th_j = out["theta"][..., j]
            c_j = torch.stack([out["x"][..., j] + wb * torch.cos(th_j),
                               out["y"][..., j] + wb * torch.sin(th_j)], dim=-1)
            if kap is not None:
                # θ before this sub-step (a standstill agent holds it: yaw 0),
                # κ held by standstill and frozen agents
                th_prev = torch.where(step_ok, theta, th_prev)
                kap = torch.where(mov, out["kappa"][..., j], kap)
            center = torch.where(mov[..., None], c_j, center)
            theta = torch.where(mov, th_j, theta)
            # a standstill agent holds its pose and brakes to zero
            zero = torch.zeros_like(v)
            v = torch.where(mov, out["v"][..., j], torch.where(hold, zero, v))
            acc = torch.where(mov, out["a"][..., j], torch.where(hold, zero, acc))
            hold_cl = torch.where(self.hold_cols, x_cl, torch.zeros_like(x_cl))
            x_cl = torch.where(mov[..., None], torch.stack(
                [out["s"][..., j], out["s_dot"][..., j], out["s_ddot"][..., j],
                 out["d"][..., j], out["d_dot"][..., j], out["d_ddot"][..., j]],
                dim=-1), torch.where(hold[..., None], hold_cl, x_cl))

            # collisions at the new poses, in the host's order
            # (`Simulation._check_collisions`): each agent checks the
            # obstacles, then the live peers; an agent marked COLLISION has
            # left the world for the agents after it, so of two agents that
            # overlap each other only the first in order is marked
            op = at(g.obst_poses, t_glob)                             # (..., O, 3)
            ov = at(g.obst_valid, t_glob)
            hit_obs = torch.any(
                obb_overlap(center[..., :, None, :], theta[..., :, None], self.h_agent,
                            op[..., None, :, :2], op[..., None, :, 2],
                            g.obst_half[..., None, :, :]) & ov[..., None, :], dim=-1)
            pair = obb_overlap(center[..., :, None, :], theta[..., :, None],
                               self.h_agent, center[..., None, :, :],
                               theta[..., None, :], self.h_agent) & ~self.eye
            marked = torch.zeros_like(step_ok)
            for i in range(a_n):
                hit = hit_obs[..., i] | torch.any(pair[..., i, :] & step_ok & ~marked,
                                                  dim=-1)
                marked = torch.where(self.eye[i], (hit & step_ok[..., i])[..., None],
                                     marked)
            status = torch.where(marked, _COLLISION, status)
            running = status == _RUNNING
            traj_steps.append(torch.cat(
                [center, theta[..., None], v[..., None], acc[..., None]], dim=-1))
            status_steps.append(status)

        # --- outputs of this cycle, then the carry ---------------------------
        o = self.out
        o["traj"].index_copy_(0, c, torch.stack(traj_steps, dim=nl)[None])
        o["status_steps"].index_copy_(0, c, torch.stack(status_steps, dim=nl)[None])
        o["sel"].index_copy_(0, c, out["sel"][None])
        o["found"].index_copy_(0, c, found[None])
        o["cost"].index_copy_(0, c, out["cost"][None])
        o["x_cl"].index_copy_(0, c, x_cl_replan[None])
        for name in MARGINS if self.emit_margins else ():
            o[name].index_copy_(0, c, out[name][None])
        new = dict(x_cl=x_cl, center=center, theta=theta, v=v, acc=acc, status=status,
                   bank=bank, bank_len=bank_len, last_exec=last_exec, kap=kap,
                   th_prev=th_prev)
        for name, value in new.items():
            if value is not None:
                st[name].copy_(value)
        if self.use_fsm:
            for f in fields(self.fsm_state):
                getattr(self.fsm_state, f.name).copy_(getattr(fsm_new, f.name))
        c.add_(1)

    def _window_predictions(self, c, t0, center, theta, v, running_pre, bank, bank_len):
        """This cycle's prediction rows from the run's own tensors: the
        scenario obstacles' window with the radius / cone filter and the
        visible-area stage, the live peers' rows, the occlusion module's
        phantoms.  Returns (preds, the post-pass inputs)."""
        p, g, nl, lead, a_n = self.p, self.g, self.nl, self.lead, self.a_n
        veh, pcfg = p.veh, p.config.prediction
        k, dt = p.k_replan, p.dt

        def at(x, index):
            return torch.index_select(x, nl, index).squeeze(nl)

        def window_field(name):
            w = at(g.pred_windows[name], c)               # (..., O, ...)
            return w.unsqueeze(nl).expand(lead + (a_n,) + tuple(w.shape[nl:]))

        window = PredictionTensors(*(window_field(f) for f in PredictionTensors._fields))
        horizon = window.means.shape[-2]
        # the occluding edges of this cycle (the sensor stage, occ_um)
        occl = None
        if p.use_vis_occl or p.use_occ_geom:
            occl = self._occluders(t0, center, theta, running_pre)
        if pcfg.use_sensor_model:
            # radius and rear-cone filter on the scenario obstacles' rows
            # (`sensor_model.obstacles_in_radius`, `filter_cone_angle`),
            # applied before the peers are appended
            cur = at(g.cur_obst, c)                       # (..., O, 3)
            rel = cur[..., None, :, :2] - center[..., :, None, :]     # (..., A, O, 2)
            in_radius = (torch.linalg.norm(rel, dim=-1) < float(pcfg.sensor_radius)) \
                & at(g.cur_obst_valid, c)[..., None, :]
            c0 = torch.cos(-theta)[..., None]
            s0 = torch.sin(-theta)[..., None]
            loc_x = c0 * rel[..., 0] - s0 * rel[..., 1] - veh.length / 2.0
            loc_y = s0 * rel[..., 0] + c0 * rel[..., 1]
            dist = torch.sqrt(loc_x ** 2 + loc_y ** 2)
            ang = torch.atan2(loc_y, loc_x)
            cone_half = float(pcfg.cone_angle) * np.pi / 180.0 / 2.0
            dropped = ((loc_x < 0) & (dist > float(pcfg.cone_safety_dist))
                       & (torch.abs(torch.abs(ang) - np.pi) < cone_half))
            sensor_ok = in_radius & ~dropped
            if p.use_vis_occl:
                # the visible-area stage (`sensor_model.visible_obstacles`):
                # a polar map per agent from the road walls, the scenario
                # obstacles at the replan step and the live peers, probed at
                # each window row's corners and center
                segs_o, segs_p, o4, p4 = occl
                road = g.road_segs
                seg = torch.cat([road, segs_o, segs_p], dim=-3)[..., None, :, :, :]
                seg_ok = torch.cat([torch.ones(lead + (a_n, road.shape[-3]),
                                               dtype=torch.bool, device=center.device),
                                    o4, p4], dim=-1)
                r_vis = polar_visibility_batch(center, seg[..., 0, :], seg[..., 1, :],
                                               seg_ok, float(pcfg.sensor_radius))
                sensor_ok = sensor_ok & visible_window_rows(
                    center, r_vis, cur, at(g.cur_half, c))
            window = window._replace(valid=window.valid & sensor_ok[..., None])
        peer_kw = dict(horizon=horizon, length=veh.length + 0.5, width=veh.width + 0.2,
                       cov_pos=pcfg.cov_pos, active=running_pre)
        if pcfg.mode == "ground_truth":
            # the rest of each peer's executing plan from the carried bank:
            # offset 1 at cycle 0 (the seed holds the states of the current
            # step), k + 1 afterwards (selected one cycle ago, k steps done)
            agent_preds = agent_plan_predictions(
                bank, bank_len, torch.where(c == 0, 1, k + 1), **peer_kw)
        else:
            poses_all = torch.cat([center, theta[..., None], v[..., None]], dim=-1)
            agent_preds = agent_pose_predictions(poses_all, dt=dt, **peer_kw)
        preds = concat_obstacles(window, agent_preds)
        post = {}
        if p.use_occlusion:
            preds, post = self._phantoms(window, preds, c, center, running_pre, occl)
        return preds, post

    def _occluders(self, t0, center, theta, running_pre):
        """`occluder_segments` of this cycle (the scenario obstacles at the
        replan step t0 and the live peers), computed once per cycle."""
        g, nl = self.g, self.nl
        obst = torch.index_select(g.obst_poses, nl, t0).squeeze(nl)
        valid = torch.index_select(g.obst_valid, nl, t0).squeeze(nl)
        return occluder_segments(obst, valid, g.obst_half, center, theta,
                                 self.h_agent, running_pre, self.eye)

    def _phantoms(self, window, preds, c, center, running_pre, occl):
        """The occlusion module in the run (`Simulation._agent_predictions` →
        `augment_predictions`): phantom rows after the window and peer rows,
        capped by the free slots the host would have left at the NOMINAL
        width `prediction.max_obstacles` (the run holds fewer slots), and
        the post-pass inputs: the phantom mask and, for occ_um / occ_ve, the
        ego, its polar map without road walls and the spawn points."""
        p, g, nl = self.p, self.g, self.nl
        pcfg, occ = p.config.prediction, p.config.occlusion
        n_present = torch.sum(torch.any(window.valid, dim=-1), dim=-1)      # (..., A)
        n_peers = (torch.sum(running_pre, dim=-1, keepdim=True)
                   - running_pre.to(n_present.dtype))
        n_free = int(pcfg.max_obstacles) - n_present - n_peers

        def at_c(x):
            return torch.index_select(x, nl, c).squeeze(nl)

        kind = PHANTOM_TYPES[occ.phantom_type]
        ph, ph_mask, ph_pos = phantom_rows(
            center, n_free, at_c(g.occ_obst), at_c(g.occ_obst_valid), g.occ_is_dyn,
            g.occ_half, g.occ_cat_ok, g.turn_xy, g.turn_spawn, g.turn_heading,
            g.turn_hot, horizon=window.means.shape[-2], dt=p.dt,
            sensor_radius=float(pcfg.sensor_radius),
            max_phantoms=int(occ.max_phantoms),
            max_dynamic=int(occ.max_dynamic_spawn_points),
            max_static=int(occ.max_static_spawn_points),
            use_turn=bool(occ.spawn_points_behind_turn), velocity=kind["velocity"],
            var_factor=float(occ.variance_factor),
            length=kind["length"] * float(occ.size_factor_length),
            width=kind["width"] * float(occ.size_factor_width))
        n_rows = preds.valid.shape[-2]
        pm = torch.cat([torch.zeros(ph_mask.shape[:-1] + (n_rows,), dtype=torch.bool,
                                    device=ph_mask.device), ph_mask], dim=-1)
        post = {"pm": pm}
        if p.use_occ_geom:
            # occ_um's polar map: obstacles and live peers occlude, the road
            # walls do not (`OcclusionModule.polar_map`)
            segs_o, segs_p, o4, p4 = occl
            seg = torch.cat([segs_o, segs_p], dim=-3)[..., None, :, :, :]
            r_vis = polar_visibility_batch(center, seg[..., 0, :], seg[..., 1, :],
                                           torch.cat([o4, p4], dim=-1),
                                           float(pcfg.sensor_radius))
            post["geom"] = (center, r_vis, ph_pos, ph_mask)
        return concat_obstacles(preds, ph), post

    # ----------------------------------------------------------------- run
    def _capture(self) -> None:
        """Capture the body into a CUDA graph (`_Graph`: one warm-up pass on
        a side stream, then the capture), dropping the stale graph first.
        The carry and outputs are put back as they were before the warm-up
        wrote them: a capture may come in the middle of a hybrid run."""
        t_start = time.perf_counter()
        self.graph = None
        with tracing.span("frenetix.device_sim.capture"):
            saved = [b.clone() for b in self._buffers()]
            self.graph = _Graph(self.step, self.device)
            for b, s in zip(self._buffers(), saved):
                b.copy_(s)
        self.capture_s = time.perf_counter() - t_start
        tracing.count("device_sim.captures", 1)
        tracing.count("device_sim.programs", self.graph.counts.get("kernel.k1.launches", 0))

    def advance(self, use_graph: bool) -> None:
        """One cycle: a replay of the captured body, or the body itself."""
        if use_graph:
            self.graph.replay()
        else:
            self.step()

    def fetch_carry(self, prev_cycle=None) -> dict:
        """The small per-cycle fetch of the hybrid path: the carried pose,
        curvilinear state and status, with behavior the curvature and the
        previous orientation, and with `prev_cycle` that cycle's executed
        sub-steps (`traj` (k, A, 5) and `status_steps` (k, A): the walenet
        mirrors' histories), all in one copy."""
        names = ["x_cl", "center", "theta", "v", "acc", "status"]
        if self.hybrid:
            names += ["kap", "th_prev"]
        parts = [self.state[n] for n in names]
        if prev_cycle is not None:
            names += ["traj", "status_steps"]
            parts += [self.out["traj"][prev_cycle], self.out["status_steps"][prev_cycle]]
        # statuses are small integers: exact in float32
        host = torch.cat([t.to(self.dtype).reshape(-1) for t in parts]).cpu().numpy()
        tracing.count("device_sim.fetches", 1)
        out, pos = {}, 0
        for n, t in zip(names, parts):
            out[n] = host[pos:pos + t.numel()].reshape(tuple(t.shape))
            pos += t.numel()
        out["status"] = out["status"].astype(np.int32)
        if prev_cycle is not None:
            out["status_steps"] = out["status_steps"].astype(np.int32)
        return out

    def fetch_outputs(self) -> dict:
        """THE one fetch of a run: statuses, per-step trajectories and
        statuses, selections, found flags, replan states (and the FSM's bail
        flag, the selection margins), packed into one tensor."""
        margins = MARGINS if self.emit_margins else ()
        parts = [self.state["status"], *(self.out[n] for n in (
            "traj", "status_steps", "sel", "found", "x_cl", "cost"))]
        parts += [self.out[n] for n in margins]
        if self.use_fsm:
            parts.append(self.fsm_state.bail)
        # statuses and flags are small integers: exact in float32
        packed = torch.cat([t.to(self.dtype).reshape(-1) for t in parts])
        host = packed.cpu().numpy()
        tracing.count("device_sim.fetches", 1)
        arrays, pos = [], 0
        for t in parts:
            arrays.append(host[pos:pos + t.numel()].reshape(tuple(t.shape)))
            pos += t.numel()
        status, traj, status_steps, sel, found, x_cl, cost = arrays[:7]
        out = dict(final_status=status.astype(np.int32), trajectories=traj,
                   status_per_step=status_steps.astype(np.int32), selections=sel,
                   found=found != 0, x_cl_cycles=x_cl, costs=cost)
        out.update(zip(margins, arrays[7:7 + len(margins)]))
        out["bail"] = (arrays[-1] != 0) if self.use_fsm else np.zeros(self.lead, bool)
        return out

    def run(self, graph: bool = True, sync_debug: bool = False) -> dict:
        """Drive the whole run and fetch once.  Returns the host arrays
        final_status, trajectories, status_per_step, selections, found,
        x_cl_cycles (cycle or step axis first, then the leading axes), bail,
        and the run's facts (`k1_launches`, `graph`, `capture_s`)."""
        use_graph = bool(graph) and self.device.type == "cuda"
        guard = contextlib.nullcontext()
        if self.device.type == "cuda":
            guard = torch.cuda.device(self.device)
        with torch.no_grad(), guard:
            capture_s = 0.0
            if use_graph and (self.graph is None or self.graph.stale):
                self.reset()          # the warm-up runs on the run's inputs
                self._capture()
                capture_s = self.capture_s
            with tracing.span("frenetix.device_sim.reset"):
                self.reset()
            launched = _launches()
            with _no_sync_allowed(sync_debug and self.device.type == "cuda"), \
                    tracing.span("frenetix.device_sim.replay"), \
                    tracing.stream_span("frenetix.device_sim.cycles", self.device):
                for _ in range(self.n_cycles):
                    self.advance(use_graph)
            launched = _launches() - launched
            tracing.count("device_sim.cycles", self.n_cycles)
            with tracing.span("frenetix.device_sim.fetch"):
                out = self.fetch_outputs()
        out.update(_launch_facts(launched), graph=use_graph, capture_s=capture_s)
        return out



_KERNELS = ("k1", "k2", "k3")


def _launches() -> np.ndarray:
    """K1's, K2's and K3's launches so far (`kernel.k1.launches`, `.k2`,
    `.k3`)."""
    return np.array([tracing.COUNTERS.get(f"kernel.{k}.launches", 0) for k in _KERNELS],
                    dtype=np.int64)


def _launch_facts(launched) -> dict:
    """`k1_launches`, `k2_launches` and `k3_launches` of a `_launches()`
    difference."""
    return {f"{k}_launches": int(n) for k, n in zip(_KERNELS, launched)}


@contextlib.contextmanager
def _no_sync_allowed(on: bool):
    """With `on`, any operation that makes the host wait for the CUDA device
    raises inside the block (`torch.cuda.set_sync_debug_mode("error")`)."""
    if not on:
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def _member_arrays(out: dict, member=None) -> dict:
    """The fetched arrays of one scenario with the step axis merged:
    trajectories (C·k, A, 5), status_per_step (C·k, A); `member` picks a
    fleet's scenario."""
    pick = (lambda x, axis: x) if member is None else (
        lambda x, axis: np.take(x, member, axis=axis))
    traj = pick(out["trajectories"], 1)                  # (C, k, A, 5)
    sps = pick(out["status_per_step"], 1)                # (C, k, A)
    return dict(
        final_status=pick(out["final_status"], 0),
        trajectories=traj.reshape((-1,) + traj.shape[2:]),
        status_per_step=sps.reshape((-1,) + sps.shape[2:]),
        selections=pick(out["selections"], 1),
        found=pick(out["found"], 1),
        costs=pick(out["costs"], 1),
        x_cl_cycles=pick(out["x_cl_cycles"], 1),
        **{name: pick(out[name], 1) for name in MARGINS if name in out},
    )


class DeviceSimulation:
    """Device-resident run of an (already constructed) host `Simulation`.

        sim = Simulation(scenario, config)       # host set-up only, not run
        dres = DeviceSimulation(sim).run()

    The host Simulation provides the agents (routes, reference paths,
    corridors), which are stacked once; everything per step happens on the
    device.  `device` defaults to the simulation's own, which defaults to
    the CUDA device and raises where there is none.

    With a `mesh` (`parallel.mesh.make_agent_mesh`, every rank of it
    constructing the same run) the agents are split over its ranks: each
    evaluates its rows of every program and all-gathers the selection, so
    every rank drives the same run to the same result.  The agent count
    must divide over the mesh.

    With the behavior planner, `fsm_in_scan` says whether the FSM runs in
    the run (else `fsm_reason` says why not, and `run` takes the hybrid
    path, which steps the host Simulation's agents and behavior modules as
    mirrors of the device state: a hybrid run is made once per
    DeviceSimulation).  A walenet run always takes the hybrid path, with the
    same rule."""

    def __init__(self, sim, device=None, mesh=None, axis_name: str = "agents"):
        config = sim.config
        if mesh is not None:
            if len(sim.agents) % mesh.size() != 0:
                raise ValueError(
                    f"agent count {len(sim.agents)} must divide evenly over the "
                    f"{mesh.size()}-rank mesh")
            check_axis(mesh, axis_name)
            if mesh.get_coordinate() is None:
                raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self.mesh = mesh
        pcfg, p = config.prediction, config.planning
        if pcfg.mode == "walenet" and config.occlusion.use_occlusion_module:
            raise NotImplementedError(
                "walenet + occlusion module is host-loop only (the device run "
                "does not thread host phantom geometry); run sim.run() instead")
        if pcfg.mode not in ("ground_truth", "constant_velocity", "walenet"):
            raise ValueError(f"unknown prediction mode {pcfg.mode!r}")
        if p.emergency_mode not in ("stopping", "min_risk"):
            raise ValueError(f"unknown emergency_mode {p.emergency_mode!r}")

        self.sim = sim
        self.config = config
        # walenet: the net reads the agents' executed histories, which no
        # precomputed window holds; every cycle the host builds the rows from
        # mirrors of the run's state (`_drive_hybrid`, `_hybrid_pred_cycle`)
        self.hybrid_pred = pcfg.mode == "walenet"
        self.device = torch.device(device) if device is not None else sim.device
        self.agents = sim.agents
        self.veh = config.vehicle
        self.dt = p.dt
        self.n_steps = p.n_steps
        self.horizon = p.planning_horizon
        self.k_replan = int(p.replanning_frequency)
        self.max_steps = int(sim.max_steps)
        self.n_cycles = (self.max_steps + self.k_replan - 1) // self.k_replan
        self.np_dtype = dtype = np.float64 if config.dtype == "float64" else np.float32
        self.dtype = torch.float64 if config.dtype == "float64" else torch.float32
        self.emergency_mode = str(p.emergency_mode)
        self.compensated_sum = bool(p.compensated_cost_sum)
        self.d_ego_pos = bool(p.d_ego_pos)
        self.weights_np = np.array(
            [config.cost_weights.get(k, 0.0) for k in COST_TERM_ORDER], dtype)

        # the post-passes: the responsibility term, the visible-area sensor
        # stage, the occlusion module (phantoms, gate, soft costs)
        occ_cfg = config.occlusion
        self.resp_weight = float(config.cost_weights.get("responsibility", 0.0))
        self.use_vis_occl = bool(pcfg.use_sensor_model and pcfg.calc_occlusions)
        self.use_occlusion = bool(occ_cfg.use_occlusion_module)
        ew = config.external_cost_weights
        self.occ_pm_weight, self.occ_um_weight, self.occ_ve_weight = (
            float(ew.get(k, 0.0)) if self.use_occlusion else 0.0
            for k in ("occ_pm", "occ_um", "occ_ve"))
        self.use_occ_geom = self.use_occlusion and (
            self.occ_um_weight != 0.0 or self.occ_ve_weight != 0.0)
        self.thresholds = (PhantomThresholds.from_config(occ_cfg)
                           if self.use_occlusion else None)
        self.need_risks = (self.resp_weight != 0.0 or self.use_occlusion
                           or self.emergency_mode == "min_risk")
        occ_statics = (False,)
        if self.use_occlusion:
            occ_statics = (
                True, self.occ_pm_weight, self.occ_um_weight, self.occ_ve_weight,
                occ_cfg.phantom_type, int(occ_cfg.max_phantoms),
                int(occ_cfg.max_dynamic_spawn_points),
                int(occ_cfg.max_static_spawn_points),
                bool(occ_cfg.spawn_points_behind_turn),
                bool(occ_cfg.spawn_point_behind_dynamic_obstacle),
                bool(occ_cfg.spawn_point_behind_static_obstacle),
                float(occ_cfg.variance_factor), float(occ_cfg.size_factor_length),
                float(occ_cfg.size_factor_width), tuple(self.thresholds))

        # static grids per densification level (the host loop evaluates
        # levels sampling_min .. sampling_max - 1 until one finds a candidate)
        self.levels = []          # [(t_grid, n_v, n_d, m_total)]
        for level in range(p.sampling_min, max(p.sampling_max, p.sampling_min + 1)):
            t1 = smp.time_samples(p.t_min, self.horizon, self.dt, level)
            t1 = np.unique(np.concatenate([t1, [self.n_steps * self.dt]]))
            n_v = len(smp.linspace_samples(0.0, 1.0, level))
            n_d = len(smp.linspace_samples(p.d_min, p.d_max, level))
            self.levels.append((t1.astype(dtype), n_v, n_d,
                                len(t1) * (n_v + 1) * (n_d + 1)))

        # the behavior planner: the stopping matrix has the first level's
        # end times and end positions and the lateral grid one level coarser
        # (`ReactivePlanner._stopping_matrix`; the host tries stopping only
        # at the first level)
        bcfg = config.behavior
        self.hybrid_behavior = bool(bcfg.use_behavior_planner)
        if bcfg.device_fsm not in ("auto", "hybrid"):
            raise ValueError(f"behavior.device_fsm={bcfg.device_fsm!r}: expected "
                             "'auto' or 'hybrid'")
        self.stop_n_d = len(smp.linspace_samples(0.0, 1.0, max(p.sampling_min - 1, 0)))
        self.stop_bucket = 0
        if self.hybrid_behavior:
            t_n, n_s = len(self.levels[0][0]), self.levels[0][1]
            self.stop_bucket = t_n * n_s * (self.stop_n_d + 1)
        self.fsm_in_scan = False
        self.fsm_reason = "behavior planner off"
        fsm_tensors = fsm_carry = None
        if self.hybrid_behavior:
            self.fsm_reason = "behavior.device_fsm = 'hybrid'"
            if self.hybrid_pred:
                self.fsm_reason = "walenet predictions run on the hybrid path"
            elif bcfg.device_fsm == "auto":
                fsm_tensors, self.fsm_in_scan, self.fsm_reason = build_fsm_tensors(
                    sim, dtype)
                if self.fsm_in_scan:
                    fsm_carry = fsm_carry0(self.agents, sim.scenario, dtype)
        self.fsm_step = make_fsm_step(config, self.veh, self.dt, self.k_replan)

        # initial per-agent state
        a_n = len(self.agents)
        x_cl0 = np.zeros((a_n, 6), dtype)
        pose0 = np.zeros((a_n, 4), dtype)   # center x, y, theta, v
        acc0 = np.zeros(a_n, dtype)
        for i, a in enumerate(self.agents):
            lon, lat = a.ensure_x_cl()
            x_cl0[i] = np.concatenate([np.asarray(lon), np.asarray(lat)])
            pose0[i] = (*a.state.position, a.state.orientation, a.state.velocity)
            acc0[i] = a.state.acceleration
        self.pose0 = pose0

        # peer plan-bank seed (`Simulation._peer_future` before the first
        # plan): the converted obstacle's recorded trajectory, or a
        # constant-velocity pseudo-plan.  bank[j] is the center state at
        # global step j; entries 1 .. bank_len - 1 are read
        self.bank_w = w_bank = max(self.n_steps + 1, int(pcfg.horizon_steps) + 1)
        bank0 = np.zeros((a_n, w_bank, 4), dtype)
        bank_len0 = np.zeros(a_n, np.int32)
        for i, a in enumerate(self.agents):
            ob = sim.scenario.obstacles.get(a.id)
            n_rec = 0
            if ob is not None:
                for j in range(w_bank):
                    st = ob.state_at_time(j)
                    if st is None:
                        break
                    bank0[i, j] = (*st.position, st.orientation, st.velocity)
                    n_rec += 1
            if n_rec > 1:
                bank0[i, n_rec:] = bank0[i, n_rec - 1]
                bank_len0[i] = n_rec
            else:
                x, y, th, v0 = pose0[i]
                steps = np.arange(w_bank, dtype=dtype)
                bank0[i, :, 0] = x + v0 * self.dt * steps * np.cos(th)
                bank0[i, :, 1] = y + v0 * self.dt * steps * np.sin(th)
                bank0[i, :, 2] = th
                bank0[i, :, 3] = v0
                bank_len0[i] = w_bank

        g_rings, g_ring_valid, g_ring_v, g_vo_has, g_vo_int = _goal_tensors(
            self.agents, dtype)
        goal_s, has_goal_s, goal_t_hi, has_goal_t, goal_v_mean = \
            _velocity_goal_tensors(self.agents, dtype)

        # the scenario obstacles' prediction window of every cycle, from the
        # host's own routine, and their row-aligned current poses for the
        # sensor filter (the host filter reads the pose at the replan step)
        pds, cur_obst, cur_valid, cur_half = [], [], [], []
        for c in range(self.n_cycles):
            t_c = c * self.k_replan
            if self.hybrid_pred:
                # no window: the host builds each cycle's rows in the run
                pd, ids = ground_truth_predictions(
                    sim.scenario, [], t_c, pcfg.horizon_steps,
                    max_obstacles=pcfg.max_obstacles, dtype=dtype), []
            else:
                pd, ids = sim._predictions_for_step(t_c)
            pds.append(pd)
            o_slots = pd["valid"].shape[0]
            cur = np.zeros((o_slots, 3), dtype)
            cv = np.zeros(o_slots, bool)
            ch = np.zeros((o_slots, 2), dtype)
            for row, oid in enumerate(ids[:o_slots]):
                ob = sim.scenario.obstacles[oid]
                # the visible-area probe uses the obstacle's own size, not the
                # prediction's enlarged one
                ch[row] = (ob.length / 2.0, ob.width / 2.0)
                st = ob.state_at_time(t_c)
                if st is None:
                    continue
                cur[row, :2] = st.position
                cur[row, 2] = st.orientation
                cv[row] = True
            cur_obst.append(cur)
            cur_valid.append(cv)
            cur_half.append(ch)
        obst_poses, obst_valid, obst_half = _obstacle_step_poses(
            sim.scenario, sim.agent_obstacle_ids, self.max_steps + self.k_replan, dtype)

        post_tensors = {}
        if self.resp_weight != 0.0:
            lane = lanelet_tensors(sim.scenario, device=torch.device("cpu"),
                                   dtype=self.dtype)
            post_tensors["lane"] = type(lane)(*(x.numpy() for x in lane))
        if self.use_vis_occl:
            post_tensors["road_segs"] = np.asarray(
                road_boundary_segments(sim.scenario), dtype=dtype).reshape(-1, 2, 2)
            post_tensors["cur_half"] = np.stack(cur_half)
        if self.use_occlusion:
            post_tensors.update(_occlusion_spawn_tensors(
                sim, self.agents, self.n_cycles, self.k_replan, dtype))

        # per-agent tables, stacked as on the batched host path
        cpu = torch.device("cpu")
        stepper = BatchedAgentStepper(config, self.agents, cpu)
        self.tensors = SimTensors(
            ref=RefPathTable(*(f.numpy() for f in stepper.ref)),
            corridors=stepper.corridors.numpy(),
            lane_segments=stepper.lane_segments.numpy(),
            lane_valid=stepper.lane_valid.numpy(),
            pred_windows={k: np.stack([pd[k] for pd in pds])
                          for k in PredictionTensors._fields},
            cur_obst=np.stack(cur_obst), cur_obst_valid=np.stack(cur_valid),
            obst_poses=obst_poses, obst_valid=obst_valid, obst_half=obst_half,
            g_rings=g_rings, g_ring_valid=g_ring_valid, g_ring_v=g_ring_v,
            g_vo_has=g_vo_has, g_vo_int=g_vo_int, goal_s=goal_s,
            has_goal_s=has_goal_s, goal_t_hi=goal_t_hi, has_goal_t=has_goal_t,
            goal_v_mean=goal_v_mean,
            max_steps=np.asarray(self.max_steps, np.int32),
            active0=np.ones(a_n, bool), x_cl0=x_cl0, pose0=pose0, acc0=acc0,
            bank0=bank0, bank_len0=bank_len0, fsm=fsm_tensors, fsm_carry0=fsm_carry,
            **post_tensors,
        )
        # what fleet members must share: everything the body reads from the
        # prototype member instead of the stacked tensors
        self.statics = (
            self.dt, self.n_steps, self.k_replan, self.horizon,
            tuple((tuple(l[0].tolist()), l[1], l[2], l[3]) for l in self.levels),
            str(self.dtype), str(self.device), self.emergency_mode,
            self.compensated_sum, self.d_ego_pos, p.d_min, p.d_max,
            p.low_vel_mode_threshold, tuple(self.veh), tuple(self.weights_np.tolist()),
            pcfg.mode, pcfg.use_sensor_model, pcfg.sensor_radius, pcfg.cone_angle,
            pcfg.cone_safety_dist, pcfg.cov_pos, pcfg.max_obstacles,
            pcfg.horizon_steps, self.bank_w, self.hybrid_behavior, self.stop_bucket,
            tuple(sorted((k_, v_) for k_, v_ in dataclasses.asdict(bcfg).items()
                         if k_ != "device_fsm")),
            self.resp_weight, self.use_vis_occl, occ_statics,
        )
        self._runner = None
        self._margin_runner = None

    # ------------------------------------------------------------------- run
    def run(self, graph: bool = True, sync_debug: bool = False,
            emit_margins: bool = False) -> DeviceSimResult:
        """The whole run on the device and one fetch.

        On a CUDA device the body is captured into a CUDA graph at the first
        call and replayed; `graph=False` keeps the eager loop there (what the
        CPU always runs), for checks of the replayed run against it.  With
        `sync_debug` the loop raises on a CUDA device if anything in it makes
        the host wait for the device.  A walenet run, a behavior run outside
        the FSM's scope, or one whose FSM bailed, takes the hybrid path
        instead (`_drive_hybrid`: one fetch per cycle, `sync_debug` does not
        apply).

        `emit_margins` is a diagnostic: a body of its own (its own graph)
        also writes every cycle's selection margins, which the same one fetch
        brings back as `extras["margin_gap"]` and `extras["margin_rel"]`,
        (C, A) (`select_with_fallback`).  The hybrid path carries none and
        raises ValueError."""
        t_start = time.perf_counter()
        if self.hybrid_pred or (self.hybrid_behavior and not self.fsm_in_scan):
            _no_hybrid_margins(emit_margins, self.fsm_reason)
            res = _drive_hybrid([self], graph=graph)[0]
        else:
            if emit_margins:
                if self._margin_runner is None:
                    self._margin_runner = _Runner(self, self.tensors, self.n_cycles,
                                                  emit_margins=True)
                runner = self._margin_runner
            else:
                if self._runner is None:
                    self._runner = _Runner(self, self.tensors, self.n_cycles)
                runner = self._runner
                # a runner shared with other scenarios (`share_runner`)
                runner.take(self, lambda: self.tensors, "frenetix.device_sim.load")
            out = runner.run(graph=graph, sync_debug=sync_debug)
            if out["bail"]:
                # the in-run FSM wanted to overtake, which only the host FSM
                # carries: the whole run again on the hybrid path
                _no_hybrid_margins(emit_margins, "the in-run FSM bailed")
                res = _drive_hybrid([self], graph=graph)[0]
                res.extras["bailed"] = True
            else:
                with tracing.span("frenetix.device_sim.finalize"):
                    res = self._finalize(_member_arrays(out), out)
        res.wall_time = time.perf_counter() - t_start
        return res

    def _finalize(self, arrays: dict, facts: dict) -> DeviceSimResult:
        """Host epilogue on one scenario's fetched arrays: cut to this
        scenario's max_steps, cycles and agents (a fleet pads all three);
        agents still RUNNING at the end get TIMELIMIT."""
        a_n, c_n = len(self.agents), self.n_cycles
        status = np.array(arrays["final_status"][:a_n])
        status[status == _RUNNING] = _TIMELIMIT
        traj = arrays["trajectories"][: self.max_steps, :a_n]
        sps = arrays["status_per_step"][: self.max_steps, :a_n]
        # the host loop stops once no agent is RUNNING after a step
        # (sps[i] is the status after executed step i + 1)
        alive = (sps == _RUNNING).any(axis=1)
        steps = self.max_steps if alive.all() else int(np.argmin(alive)) + 1
        return DeviceSimResult(
            agent_ids=[a.id for a in self.agents], status=status, steps=steps,
            trajectories=traj, status_per_step=sps,
            selections=arrays["selections"][:c_n, :a_n],
            found=arrays["found"][:c_n, :a_n], costs=arrays["costs"][:c_n, :a_n],
            extras={"x_cl_cycles": arrays["x_cl_cycles"][:c_n, :a_n],
                    **{k: arrays[k][:c_n, :a_n] for k in MARGINS if k in arrays},
                    **{k: facts[k] for k in ("k1_launches", "k2_launches", "k3_launches",
                                             "graph", "capture_s", "fetches", "captures")
                       if k in facts}},
        )

    def to_simulation_result(self, dres: DeviceSimResult):
        """A device run in the host `SimulationResult` shape.  Histories
        follow the host's recording: the initial state, then every state
        executed while RUNNING, the colliding state included (the host
        appends it before the collision check marks the agent)."""
        from frenetix_tpu_torch.sim.simulation import SimulationResult

        wb = self.veh.wheelbase
        messages = {
            int(AgentStatus.COMPLETED_SUCCESS): "success",
            int(AgentStatus.TIMELIMIT): "time limit reached",
            int(AgentStatus.COLLISION): "collision",
            int(AgentStatus.ERROR): "no feasible trajectory",
        }
        running, collision = int(AgentStatus.RUNNING), int(AgentStatus.COLLISION)
        histories, statuses, msgs = {}, {}, {}
        for col, (aid, agent) in enumerate(zip(dres.agent_ids, self.agents)):
            states = [agent.record.states[0]]
            prev_theta = float(self.pose0[col, 2])
            for i in range(dres.steps):
                s_i = int(dres.status_per_step[i, col])
                executed = s_i == running or (
                    s_i == collision
                    and (i == 0 or int(dres.status_per_step[i - 1, col]) == running))
                if not executed:
                    break
                x, y, th, v, a = (float(f) for f in dres.trajectories[i, col])
                yaw_rate = (th - prev_theta) / self.dt
                prev_theta = th
                states.append(EgoState(
                    time_step=i + 1, position=np.array([x, y]), orientation=th,
                    velocity=v, acceleration=a, yaw_rate=yaw_rate,
                    steering_angle=float(np.arctan2(wb * yaw_rate, max(v, 1e-3)))))
            histories[aid] = states
            statuses[aid] = AgentStatus(int(dres.status[col]))
            msgs[aid] = messages.get(int(dres.status[col]), "")
        return SimulationResult(
            scenario_id=self.sim.scenario.scenario_id, agent_status=statuses,
            agent_messages=msgs, steps=dres.steps, wall_time=dres.wall_time,
            planning_times=[], histories=histories)

    # ---------------------------------------------------------------- hybrid
    def _hybrid_kappa0(self, a_pad: int) -> np.ndarray:
        """The agents' initial curvature (from the steering angle), padded
        with agent 0's."""
        kap = np.array([np.tan(float(a.state.steering_angle)) / self.veh.wheelbase
                        for a in self.agents], self.np_dtype)
        return np.concatenate([kap, np.repeat(kap[:1], a_pad - len(kap))])

    def _hybrid_restack(self) -> None:
        """The per-agent tables again after a reference-path swap, as the
        batched host path rebuilds its stepper."""
        stepper = BatchedAgentStepper(self.config, self.agents, torch.device("cpu"))
        self.tensors = dataclasses.replace(
            self.tensors, ref=RefPathTable(*(f.numpy() for f in stepper.ref)),
            corridors=stepper.corridors.numpy(),
            lane_segments=stepper.lane_segments.numpy(),
            lane_valid=stepper.lane_valid.numpy())

    def _hybrid_host_cycle(self, c: int, carry: dict, inert: bool = False,
                           synced: bool = False):
        """The host side of one hybrid cycle: bring the agents' mirrors up to
        the device state, run each running agent's behavior module and
        `apply_behavior_output`, and build the stopping matrices of the
        agents whose stop point asks for stopping mode.

        `carry` holds this member's fetched carry (its agent axis may be a
        fleet's padded one; padded rows get no stopping rows and their own
        velocity).  `inert`: a fleet member past its own cycles, whose host
        side is left alone.  `synced`: `_sync_exec_mirrors` has brought the
        mirrors up already (a walenet run).  Returns (v_des, stop_mat,
        stop_mask, wants, x_cl_new, swapped)."""
        dtype = self.np_dtype
        t0 = c * self.k_replan
        stop_thr = self.config.behavior.stopping_mode_threshold
        lvl0 = self.config.planning.sampling_min
        x_cl_h = np.asarray(carry["x_cl"])
        a_pad = x_cl_h.shape[0]
        v_des = np.asarray(carry["v"], dtype).copy()
        wants = np.zeros(a_pad, bool)
        stop_mat = np.zeros((a_pad, self.stop_bucket, 13), dtype)
        stop_mask = np.zeros((a_pad, self.stop_bucket), bool)
        x_cl_new = x_cl_h.copy()
        if inert:
            return v_des, stop_mat, stop_mask, wants, x_cl_new, False

        # the mirrors: behavior modules observe their peers' executed
        # records (WorldView).  At cycle 0 a fresh Simulation's mirrors are
        # already exact, the scenario's initial yaw rate included
        status = carry["status"]
        for i, a in enumerate(self.agents if c > 0 and not synced else ()):
            a.state = EgoState(
                time_step=t0, position=np.asarray(carry["center"][i]).copy(),
                orientation=float(carry["theta"][i]), velocity=float(carry["v"][i]),
                acceleration=float(carry["acc"][i]),
                yaw_rate=float(carry["theta"][i] - carry["th_prev"][i]) / self.dt,
                steering_angle=float(np.arctan2(
                    self.veh.wheelbase * float(carry["kap"][i]), 1.0)))
            a.x_cl = (x_cl_h[i, :3].copy(), x_cl_h[i, 3:].copy())
            if status[i] == _RUNNING and (
                    not a.record.states or a.record.states[-1].time_step < t0):
                a.record.states.append(a.state)

        swapped = False
        for i, a in enumerate(self.agents):
            if int(status[i]) != _RUNNING:
                continue
            b_out = a.behavior.execute(None, a.state, t0)
            if apply_behavior_output(a, b_out):
                swapped = True
                lon, lat = a.x_cl
                x_cl_new[i] = np.concatenate(
                    [np.asarray(lon), np.asarray(lat)]).astype(dtype)
            v_des[i] = b_out.desired_velocity
            sp = a.planner.stop_point
            x_cl_t = (x_cl_new[i, :3], x_cl_new[i, 3:])
            if sp is not None and wants_stopping_mode(sp, x_cl_t, stop_thr):
                m = a.planner._stopping_matrix(lvl0, x_cl_t)
                stop_mat[i, :m.shape[0]] = m.astype(dtype)
                stop_mask[i, :m.shape[0]] = True
                wants[i] = True
        return v_des, stop_mat, stop_mask, wants, x_cl_new, swapped

    def _sync_exec_mirrors(self, c: int, carry: dict) -> None:
        """Bring the host agents up to the run's state for the walenet rows
        of cycle `c`: the previous cycle's executed sub-steps appended to
        each agent's record (the net reads 30-step executed histories; the
        host appends one state per executed step, the colliding one
        included), then status, state and curvilinear state.  At cycle 0 a
        fresh Simulation's agents are already exact."""
        if c == 0:
            self._mirror_prev_running = [True] * len(self.agents)
            return
        k = self.k_replan
        traj, sps = carry["traj"], carry["status_steps"]       # (k, A, 5), (k, A)
        prev_running = self._mirror_prev_running
        for i, a in enumerate(self.agents):
            was_running = prev_running[i]
            for j in range(traj.shape[0]):
                s_j = int(sps[j, i])
                executed = s_j == _RUNNING or (s_j == _COLLISION and was_running)
                was_running = s_j == _RUNNING
                if not executed:
                    continue
                x, y, th, vv, aa = (float(f) for f in traj[j, i])
                t_j = (c - 1) * k + j + 1
                if a.record.states and a.record.states[-1].time_step >= t_j:
                    continue
                prev_th = a.record.states[-1].orientation if a.record.states else th
                yaw = (th - prev_th) / self.dt
                a.record.states.append(EgoState(
                    time_step=t_j, position=np.array([x, y]), orientation=th,
                    velocity=vv, acceleration=aa, yaw_rate=yaw,
                    steering_angle=float(np.arctan2(self.veh.wheelbase * yaw,
                                                    max(vv, 1e-3)))))
            prev_running[i] = was_running
            a.status = AgentStatus(int(carry["status"][i]))
            if int(carry["status"][i]) == _RUNNING:
                a.state = EgoState(
                    time_step=c * k, position=np.asarray(carry["center"][i]).copy(),
                    orientation=float(carry["theta"][i]), velocity=float(carry["v"][i]),
                    acceleration=float(carry["acc"][i]))
                a.x_cl = (carry["x_cl"][i, :3].copy(), carry["x_cl"][i, 3:].copy())
            elif a.record.states:
                a.state = a.record.states[-1]

    def _hybrid_pred_cycle(self, c: int) -> dict:
        """The walenet rows of cycle `c`, built by the host Simulation's own
        `_predictions_for_step` and `_agent_predictions` over the synced
        mirrors (the net, the sensor filter, the peers' rows and the
        eviction) and stacked to (A, O, H, ...) arrays; agents that left the
        run get invalid rows."""
        sim = self.sim
        sim._peer_rows_cache = None
        pd_base, ids = sim._predictions_for_step(c * self.k_replan)
        a_n = len(self.agents)
        o, h = pd_base["valid"].shape
        eye = np.eye(2, dtype=self.np_dtype)
        f = dict(
            means=np.zeros((a_n, o, h, 2), self.np_dtype),
            covs=np.tile(eye, (a_n, o, h, 1, 1)), inv_covs=np.tile(eye, (a_n, o, h, 1, 1)),
            orientations=np.zeros((a_n, o, h), self.np_dtype),
            velocities=np.zeros((a_n, o, h), self.np_dtype),
            lengths=np.full((a_n, o), 4.5, self.np_dtype),
            widths=np.full((a_n, o), 2.0, self.np_dtype),
            valid=np.zeros((a_n, o, h), bool))
        for i, a in enumerate(self.agents):
            if a.status not in (AgentStatus.IDLE, AgentStatus.RUNNING):
                continue
            pd = sim._agent_predictions(pd_base, ids, a)[0]
            for name in f:
                f[name][i] = pd[name]
        return f

    # ----------------------------------------------------------------- fleet
    def _padded_tensors(self, dims: dict, use_fsm: bool = False) -> SimTensors:
        """This scenario's SimTensors padded to a fleet's maxima.

        The padding is inert: extra agents carry active0 = False (status
        ERROR from step 0, left out of predictions and collisions) and
        repeat agent 0's state and tables, so their dead computation stays
        finite; extra obstacle and goal rows carry valid = False; extra
        cycles repeat the last prediction window (every agent is frozen by
        its own max_steps long before)."""
        g = self.tensors
        a_max = dims["a"]

        def pad_a(x, axis=0):
            n = a_max - x.shape[axis]
            if n <= 0:
                return x
            return np.concatenate(
                [x, np.repeat(np.take(x, [0], axis=axis), n, axis=axis)], axis=axis)

        def pad_zero(x, size, axis):
            n = size - x.shape[axis]
            if n <= 0:
                return x
            shape = list(x.shape)
            shape[axis] = n
            return np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis)

        def pad_repeat(x, size, axis):
            n = size - x.shape[axis]
            if n <= 0:
                return x
            last = np.take(x, [x.shape[axis] - 1], axis=axis)
            return np.concatenate([x, np.repeat(last, n, axis=axis)], axis=axis)

        c, r = dims["c"], dims["r"]
        return SimTensors(
            ref=RefPathTable(**{
                name: pad_a(np.stack([
                    _pad_table(row, r, is_pathlength=(name == "s"))
                    for row in getattr(g.ref, name)]))
                for name in RefPathTable._fields}),
            corridors=pad_a(np.stack([_pad_table(row, r) for row in g.corridors])),
            lane_segments=pad_a(pad_zero(g.lane_segments, dims["s"], 1)),
            lane_valid=pad_a(pad_zero(g.lane_valid, dims["s"], 1)),
            pred_windows={k: pad_repeat(v, c, 0) for k, v in g.pred_windows.items()},
            cur_obst=pad_repeat(g.cur_obst, c, 0),
            cur_obst_valid=pad_repeat(g.cur_obst_valid, c, 0),
            obst_poses=pad_zero(pad_zero(g.obst_poses, dims["t1"], 0), dims["o"], 1),
            obst_valid=pad_zero(pad_zero(g.obst_valid, dims["t1"], 0), dims["o"], 1),
            obst_half=pad_zero(g.obst_half, dims["o"], 0),
            # ring vertices are padded by repeating the last one (no new
            # crossings), ring rows with valid = False
            g_rings=pad_a(pad_zero(pad_repeat(g.g_rings, dims["e"], 2), dims["g"], 1)),
            g_ring_valid=pad_a(pad_zero(g.g_ring_valid, dims["g"], 1)),
            g_ring_v=pad_a(pad_zero(g.g_ring_v, dims["g"], 1)),
            g_vo_has=pad_a(g.g_vo_has), g_vo_int=pad_a(g.g_vo_int),
            goal_s=pad_a(g.goal_s), has_goal_s=pad_a(g.has_goal_s),
            goal_t_hi=pad_a(g.goal_t_hi), has_goal_t=pad_a(g.has_goal_t),
            goal_v_mean=pad_a(g.goal_v_mean), max_steps=g.max_steps,
            active0=np.concatenate([np.ones(len(self.agents), bool),
                                    np.zeros(a_max - len(self.agents), bool)]),
            x_cl0=pad_a(g.x_cl0), pose0=pad_a(g.pose0), acc0=pad_a(g.acc0),
            bank0=pad_a(g.bank0), bank_len0=pad_a(g.bank_len0),
            **self._padded_fsm(dims, use_fsm),
            **self._padded_post(dims, pad_a, pad_zero, pad_repeat),
        )

    def _padded_post(self, dims: dict, pad_a, pad_zero, pad_repeat) -> dict:
        """The post-pass leaves of `_padded_tensors`.  Padding lanelets are
        all-zero rings with ring_valid and closure False (they neither start
        nor join a closure), their vertices repeat the last one; padding road
        walls and spawn obstacles are zero (a zero-length wall meets no ray,
        an invalid obstacle spawns nothing); padding route vertices are not
        hot."""
        g, out = self.tensors, {}
        c = dims["c"]
        if g.lane is not None:
            out["lane"] = type(g.lane)(
                rings=pad_zero(pad_repeat(g.lane.rings, dims["le"], 1), dims["l"], 0),
                ring_valid=pad_zero(g.lane.ring_valid, dims["l"], 0),
                closure=pad_zero(pad_zero(g.lane.closure, dims["l"], 0), dims["l"], 1))
        if g.road_segs is not None:
            out.update(road_segs=pad_zero(g.road_segs, dims["sr"], 0),
                       cur_half=pad_repeat(g.cur_half, c, 0))
        if g.occ_obst is not None:
            oc, r2 = dims["oc"], dims["r2"]
            out.update(
                occ_obst=pad_zero(pad_repeat(g.occ_obst, c, 0), oc, 1),
                occ_obst_valid=pad_zero(pad_repeat(g.occ_obst_valid, c, 0), oc, 1),
                occ_is_dyn=pad_zero(g.occ_is_dyn, oc, 0),
                occ_half=pad_zero(g.occ_half, oc, 0),
                occ_cat_ok=pad_zero(g.occ_cat_ok, oc, 0),
                **{k: pad_a(pad_zero(getattr(g, k), r2, 1))
                   for k in ("turn_xy", "turn_spawn", "turn_heading", "turn_hot")})
        return out

    def _padded_fsm(self, dims: dict, use_fsm: bool) -> dict:
        """The FSM leaves of `_padded_tensors` (none when the fleet runs
        without the in-run FSM)."""
        if not use_fsm:
            return {}
        ft, c0 = pad_fsm_tensors(self.tensors.fsm, self.tensors.fsm_carry0, dims["a"],
                                 **dims["fsm"])
        return dict(fsm=ft, fsm_carry0=c0)


def _fleet_dims(sims, use_fsm: bool = False) -> dict:
    """The fleet's maxima: agents, cycles, table rows, lane segments,
    collision obstacles, steps, goal rings and ring vertices, and with
    `use_fsm` those of the FSM tables."""
    def top(fn):
        return max(int(fn(s.tensors)) for s in sims)

    dims = dict(
        a=top(lambda g: g.x_cl0.shape[0]), c=max(s.n_cycles for s in sims),
        r=top(lambda g: g.ref.s.shape[1]), s=top(lambda g: g.lane_segments.shape[1]),
        o=top(lambda g: g.obst_half.shape[0]), t1=top(lambda g: g.obst_poses.shape[0]),
        g=top(lambda g: g.g_rings.shape[1]), e=top(lambda g: g.g_rings.shape[2]),
    )
    first = sims[0].tensors
    if first.lane is not None:
        dims.update(l=top(lambda g: g.lane.rings.shape[0]),
                    le=top(lambda g: g.lane.rings.shape[1]))
    if first.road_segs is not None:
        dims["sr"] = top(lambda g: g.road_segs.shape[0])
    if first.occ_obst is not None:
        dims.update(oc=top(lambda g: g.occ_half.shape[0]),
                    r2=top(lambda g: g.turn_hot.shape[1]))
    if use_fsm:
        dims["fsm"] = dict(
            r_max=top(lambda g: g.fsm.f_xy.shape[1]),
            g_max=top(lambda g: g.fsm.g_valid.shape[1]),
            l_max=top(lambda g: g.fsm.ll_valid.shape[0]),
            e_max=top(lambda g: g.fsm.ll_rings.shape[1]),
            ob_max=top(lambda g: g.fsm.ob_len.shape[0]),
            t1_max=top(lambda g: g.fsm.ob_pos.shape[0]),
            c_max=dims["c"])
    return dims


def _leaf_shapes(g: SimTensors) -> tuple:
    """The shape and kind of every leaf of `g`, in field order."""
    shapes = []
    _map_leaves(lambda x: shapes.append((np.shape(x), np.asarray(x).dtype.kind)), g)
    return tuple(shapes)


def share_runner(sims: list) -> None:
    """Give every simulation of `sims` one runner, so that one capture serves
    all their runs: a member's `run()` copies its own inputs into the shared
    buffers and replays (`_Runner.load`), with a result bitwise equal to its
    own fresh run.  The buffers hold the window slots any member fills.

    The members must share the statics (`DeviceSimulation.statics`), the
    mesh and the buffers' shapes (agents, cycles, table rows, obstacles,
    goal rings, bank width), and run on the run's own path (not the hybrid
    one); otherwise ValueError."""
    base = sims[0]
    for s in sims:
        if s.statics != base.statics or s.mesh is not base.mesh:
            raise ValueError("a shared runner needs the members' statics and mesh equal")
        if s.hybrid_pred or (s.hybrid_behavior and not s.fsm_in_scan):
            raise ValueError(f"a shared runner does not take the hybrid path ({s.fsm_reason})")
    keep = _kept_slots(*(s.tensors for s in sims))
    shapes = {(s.n_cycles, _leaf_shapes(_trim_slots(s.tensors, keep))) for s in sims}
    if len(shapes) > 1:
        raise ValueError("a shared runner needs the members' cycles and input shapes equal")
    runner = _Runner(base, base.tensors, base.n_cycles, keep=keep)
    for s in sims:
        s._runner = runner


def _fleet_stack(sims, dims=None, use_fsm: bool = False) -> SimTensors:
    """Every member's SimTensors padded to the fleet's maxima and stacked on
    the host along a new leading scenario axis (one upload per leaf)."""
    dims = dims or _fleet_dims(sims, use_fsm)
    return _map_leaves(lambda *xs: np.stack(xs), *(s._padded_tensors(dims, use_fsm)
                                                   for s in sims))


def _check_fleet(sims) -> None:
    """Raise ValueError unless the members can share one run: no member
    mesh, the planning statics equal."""
    base = sims[0]
    for s in sims:
        if s.mesh is not None:
            raise ValueError("run_fleet composes members without meshes (per-member "
                             "meshes are not supported; pass mesh= to run_fleet to "
                             "split the scenario axis)")
        if s.statics != base.statics:
            raise ValueError(
                "fleet members must share planning statics (dt, horizon, "
                "replanning frequency, sampling levels, dtype, device, emergency "
                "mode, compensated-sum flag, vehicle, cost weights, responsibility "
                "weight, prediction mode and sensor settings, occlusion "
                "settings, behavior settings)")


class FleetRunner:
    """One captured run for several fleets, lasting across their runs.

        runner = FleetRunner([fleet_a, fleet_b])     # lists of DeviceSimulations
        results_a = runner.run(fleet_a)              # one DeviceSimResult per member

    The runner's buffers have the scenario axis of the largest fleet handed
    in and the maxima over every member of every fleet (agents, cycles,
    table rows, obstacles, goal rings, bank width) and hold the window slots
    any member fills, so one capture serves them all.  Each fleet is padded,
    stacked and trimmed to those slots once, here, on the host (a shorter
    fleet is filled with repeats of its first member, whose results are
    dropped).  `run(fleet)` copies the fleet's stack into the buffers unless
    they hold it already (`_Runner.take`), replays and fetches once.  Each
    member's result is bitwise that of its solo run.

    The members must share the statics (`DeviceSimulation.statics`), carry
    no mesh of their own and run on the run's own path: a walenet member, or
    a behavior member outside the in-run FSM's scope, raises ValueError.  A
    member whose FSM bails is run again alone on the hybrid path.
    `emit_margins` as in `DeviceSimulation.run`."""

    def __init__(self, fleets: list, emit_margins: bool = False):
        fleets = [tuple(f) for f in fleets]
        members = [s for f in fleets for s in f]
        _check_fleet(members)
        for s in members:
            if s.hybrid_pred or (s.hybrid_behavior and not s.fsm_in_scan):
                raise ValueError(f"a fleet runner does not take the hybrid path "
                                 f"({s.fsm_reason})")
        base = members[0]
        self.size = max(len(f) for f in fleets)
        self.use_fsm = base.hybrid_behavior
        self.emit_margins = bool(emit_margins)
        self.dims = _fleet_dims(members, self.use_fsm)
        keep = _kept_slots(*(s.tensors for s in members))
        # (fleet, its padded and trimmed stack) per fleet: a run only copies
        self.fleets = []
        for f in fleets:
            filled = f + (f[0],) * (self.size - len(f))
            self.fleets.append((f, _trim_slots(_fleet_stack(filled, self.dims, self.use_fsm),
                                               keep)))
        first, stack = self.fleets[0]
        self.runner = _Runner(base, stack, self.dims["c"], keep=keep,
                              emit_margins=emit_margins)
        self.runner.loaded = first

    def run(self, fleet, graph: bool = True, sync_debug: bool = False) -> list:
        """One run of `fleet`, one of the fleets the runner was made for
        (the same members in the same order; any other raises ValueError),
        and one fetch: its members' results, in order.  `graph` and
        `sync_debug` as in `DeviceSimulation.run`."""
        members = tuple(fleet)
        known = next((k for k in self.fleets if len(k[0]) == len(members)
                      and all(a is b for a, b in zip(k[0], members))), None)
        if known is None:
            raise ValueError("a fleet runner runs only the fleets it was made for")
        owner, stack = known
        tracing.count("device_sim.fleet.members", len(members))
        tracing.count("device_sim.fleet.agent_cycles_real",
                      sum(len(s.agents) * s.n_cycles for s in members))
        tracing.count("device_sim.fleet.agent_cycles_stacked",
                      self.size * self.dims["a"] * self.dims["c"])
        self.runner.take(owner, lambda: stack, "frenetix.device_sim.fleet.load")
        out = self.runner.run(graph=graph, sync_debug=sync_debug)
        results = []
        for i, s in enumerate(members):
            if out["bail"][i]:
                # this member's FSM wanted to overtake: alone, hybrid
                _no_hybrid_margins(self.emit_margins, "a member's in-run FSM bailed")
                res = _drive_hybrid([s], graph=graph)[0]
                res.extras["bailed"] = True
            else:
                res = s._finalize(_member_arrays(out, i), out)
            results.append(res)
        return results


def _no_hybrid_margins(emit_margins: bool, why: str) -> None:
    if emit_margins:
        raise ValueError(f"emit_margins: the hybrid path carries no selection margins "
                         f"({why})")


def _drive_hybrid(sims: list, graph: bool = True) -> list:
    """The hybrid path of one simulation, or of a behavior fleet (more than
    one member: stacked along a leading scenario axis).

    Per cycle: ONE fetch of the small carry (with walenet also the previous
    cycle's executed sub-steps), the host side (walenet: `_sync_exec_mirrors`
    and `_hybrid_pred_cycle`; behavior: every member's `_hybrid_host_cycle`,
    mirrors, behavior modules, stopping matrices, a member past its own
    cycles staying inert), its outputs copied into the body's input buffers,
    then one cycle on the device (a replay of the captured single-cycle body
    on a CUDA device).  A reference-path swap restacks the
    member's tables; while they fit the run's buffers they are copied in,
    and when they grow the body gets new buffers and a new capture (counted
    in `extras["captures"]`).  The outputs stay on the device until the
    run's last fetch.  Returns one DeviceSimResult per member."""
    base = sims[0]
    fleet = len(sims) > 1
    behavior_on, pred_on = base.hybrid_behavior, base.hybrid_pred
    dims = _fleet_dims(sims)

    def inputs():
        if fleet:
            return _fleet_stack(sims, dims)
        return base._padded_tensors(dims)

    fetches0 = tracing.COUNTERS.get("device_sim.fetches", 0)
    runner = _Runner(base, inputs(), dims["c"], hybrid=behavior_on, hybrid_pred=pred_on)
    use_graph = bool(graph) and runner.device.type == "cuda"
    guard = contextlib.nullcontext()
    if runner.device.type == "cuda":
        guard = torch.cuda.device(runner.device)
    # the kernels' launches across the cycles' advances, not the host side
    captures, capture_s, launched = 0, 0.0, np.zeros(len(_KERNELS), dtype=np.int64)
    with torch.no_grad(), guard:
        runner.reset()
        if behavior_on:
            kap0 = np.stack([s._hybrid_kappa0(dims["a"]) for s in sims])
            runner.state["kap"].copy_(torch.as_tensor(kap0 if fleet else kap0[0]))
        for c in range(dims["c"]):
            carry = runner.fetch_carry(c - 1 if pred_on and c > 0 else None)
            if pred_on:
                # walenet runs one member at a time (`run_fleet`)
                base._sync_exec_mirrors(c, carry)
            if behavior_on:
                members = ([{k: v[i] for k, v in carry.items()}
                            for i in range(len(sims))] if fleet else [carry])
                results = [s._hybrid_host_cycle(c, m, inert=c >= s.n_cycles,
                                                synced=pred_on)
                           for s, m in zip(sims, members)]
                v_des, stop_mat, stop_mask, wants, x_cl_new, swapped = (
                    np.stack(x) if fleet else x[0] for x in zip(*results))
                if np.any(swapped):
                    for s, r in zip(sims, results):
                        if r[5]:
                            s._hybrid_restack()
                    grown = _fleet_dims(sims)
                    if any(grown[k] > dims[k] for k in dims):
                        # the tables outgrew the buffers: a new body
                        dims = {k: max(dims[k], grown[k]) for k in dims}
                        old = runner
                        runner = _Runner(base, inputs(), dims["c"], hybrid=True,
                                         hybrid_pred=pred_on, keep=old.keep)
                        for new_b, old_b in zip(runner._buffers(), old._buffers()):
                            new_b.copy_(old_b)
                    else:
                        runner.load(inputs())
                    runner.state["x_cl"].copy_(torch.as_tensor(x_cl_new))
                for name, value in (("v_des", v_des), ("stop_mat", stop_mat),
                                    ("stop_mask", stop_mask), ("wants", wants)):
                    runner.b_in[name].copy_(torch.as_tensor(value))
            if pred_on:
                for name, value in base._hybrid_pred_cycle(c).items():
                    runner.p_in[name].copy_(torch.as_tensor(value))
            if use_graph and runner.graph is None:
                captures += 1
                runner._capture()
                capture_s += runner.capture_s
            before = _launches()
            runner.advance(use_graph)
            launched += _launches() - before
        out = runner.fetch_outputs()
    out.update(_launch_facts(launched), graph=use_graph, capture_s=capture_s,
               captures=captures,
               fetches=tracing.COUNTERS.get("device_sim.fetches", 0) - fetches0)
    return [s._finalize(_member_arrays(out, i if fleet else None), out)
            for i, s in enumerate(sims)]


def run_fleet(sims: list, mesh=None, axis_name: str = "scenarios", chunk: int = None,
              graph: bool = True, sync_debug: bool = False,
              emit_margins: bool = False) -> list:
    """Run S device simulations as ONE run over a leading scenario axis with
    ONE fetch: the same body, on (S, A, ...) tensors, so every kernel of a
    cycle serves all scenarios and K1 runs on the (S·A·R, C) table.

    All members must share the planning and prediction statics (dt, horizon,
    replanning frequency, sampling levels, dtype, device, emergency mode,
    vehicle, cost weights, prediction mode and sensor settings, the behavior
    settings); their sizes (agents, reference length, cycles, obstacles,
    goal geometry, FSM tables) are padded to the fleet's maxima with inert
    rows (`_padded_tensors`).  Returns one DeviceSimResult per simulation,
    equal to running each alone.

    Behavior members share the in-run FSM when every member supports it;
    otherwise the whole fleet takes the hybrid path (`_drive_hybrid`, one
    small fetch per cycle).  Walenet members run one after another, each on
    its own hybrid path.  A member whose FSM wanted to overtake (`bail`)
    is run again alone on the hybrid path.

    `chunk`: run the S simulations as ceil(S / chunk) runs of `chunk` members
    through one `FleetRunner` (the same buffers and, on a CUDA device, the
    same captured graph): all groups are padded to the maxima of the whole
    fleet, the last group is filled with repeats of its first member, and
    every group is one fetch.  A `FleetRunner` of one's own keeps that
    capture across calls.  `graph` and `sync_debug` as in `DeviceSimulation.run`.

    `mesh`: the scenario axis is split over its ranks (every rank of it
    passing the same members): rank r runs members [r·S/W, (r+1)·S/W) as a
    fleet of its own, with no collective inside the run (and chunks of
    ceil(chunk / W)), and the members' results are gathered once, so every
    rank returns all S results in order.  S must divide over the mesh, and
    a member built with its own mesh raises.

    `emit_margins` as in `DeviceSimulation.run`: every member's result
    carries its own (C, A) margins, equal to its solo run's; a fleet on the
    hybrid path (walenet, behavior outside the FSM's scope) or a member
    whose FSM bailed raises ValueError."""
    t_start = time.perf_counter()
    base = sims[0]
    _check_fleet(sims)
    use_fsm = base.hybrid_behavior and all(s.fsm_in_scan for s in sims)
    if mesh is not None:
        check_axis(mesh, axis_name)
        lo, hi = mesh_rows(mesh, len(sims), "fleet size")
        local_chunk = None if chunk is None else -(-int(chunk) // mesh.size())
        mine = run_fleet(sims[lo:hi], chunk=local_chunk, graph=graph,
                         sync_debug=sync_debug, emit_margins=emit_margins)
        parts = [None] * mesh.size()
        dist.all_gather_object(parts, mine, group=mesh.get_group())
        results = [r for part in parts for r in part]
    elif base.hybrid_pred:
        # the host builds every member's rows each cycle from that member's
        # executed states: the members run one after another
        _no_hybrid_margins(emit_margins, "walenet predictions")
        results = [s.run(graph=graph) for s in sims]
    elif base.hybrid_behavior and not use_fsm:
        _no_hybrid_margins(emit_margins, "a member's behavior is outside the FSM's scope")
        results = _drive_hybrid(list(sims), graph=graph) if len(sims) > 1 \
            else [sims[0].run(graph=graph)]
    else:
        group = len(sims) if chunk is None else min(int(chunk), len(sims))
        chunks = [sims[lo:lo + group] for lo in range(0, len(sims), group)]
        runner = FleetRunner(chunks, emit_margins=emit_margins)
        results = [res for members in chunks
                   for res in runner.run(members, graph=graph, sync_debug=sync_debug)]
    wall = time.perf_counter() - t_start
    for res in results:
        res.wall_time = wall
        res.extras["fleet_size"] = len(sims)
    return results
