"""ReactivePlanner: host orchestration of the replanning cycle on a device.

PyTorch port of `frenetix_tpu/planner/reactive.py`.  Per replanning cycle it

  1. builds the sampling matrix of the current sampling level on the host
     (progressive densification from `sampling_min` up to, not including,
     `sampling_max`), or the end-position-constrained stopping matrix,
  2. runs `planner.core.evaluate_cycle` on the planner's device,
  3. copies ONE packed tensor per level to the host: a header
     [found, best_idx, feasible, collisions, off_road, histogram...], the
     selected candidate's 12 state rows and a [cost, cost_terms...] row,
  4. when nothing is selectable, applies the fallback ladder: standstill
     (v <= 0.1) → emergency stopping selection, or with
     `planning.emergency_mode = "min_risk"` the feasible candidate of lowest
     ego_risk + obst_risk over the full harm × collision-probability model
     (`risk.costs.trajectory_risks`, on the device for all candidates).

With `debug.log_risk` every selected trajectory carries its ego and obstacle
risk.

Two post-passes on a level's result, each over the risk stack on the device:
  - `cost_weights["responsibility"] != 0` and a reach grid (`set_reach_grid`):
    the reach-set responsibility term is added to the costs and the masked
    argmin runs again (`_apply_responsibility`);
  - an armed occlusion module (`set_occlusion_module`): candidates whose
    phantom metrics break the thresholds leave the selection, the soft
    `external_cost_weights` terms are added, and the re-selected candidate
    comes back in ONE more device→host copy (`_occlusion_pack`).  When the
    gate rejects every candidate the level counts as missed.

With a behavior planner (`sim.agent`) an armed stop point
(`set_stop_point`) switches the cycle to end-position-constrained stopping
sampling (`wants_stopping_mode`); when that finds nothing, the same level is
sampled regularly.

Every device program here is compiled per signature (`utils.compiled`), at
the JAX package's program boundaries: per level `evaluate_cycle`, the
responsibility re-selection (`_responsibility`) and the pack
(`_replan_pack`), then the occlusion pack (`_occlusion_pack`), the risk
totals of min_risk / `log_risk` (`_risk_program`) and the row gather of a
fallback (`_select_rows`).  `<name>.eager` is each one's body.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from frenetix_tpu_torch.geometry.corridor import corridor_from_polygons, strip_corridor
from frenetix_tpu_torch.geometry.refpath import RefPathTable, prepare_reference_path
from frenetix_tpu_torch.occlusion import external_occlusion_costs, phantom_safety_mask
from frenetix_tpu_torch.ops import sampling as smp
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER, empty_predictions
from frenetix_tpu_torch.planner.core import CycleContext, evaluate_cycle
from frenetix_tpu_torch.planner.initial_state import compute_initial_state_np
from frenetix_tpu_torch.risk.costs import trajectory_risks
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.risk.reachable_set import responsibility_reach_grid
from frenetix_tpu_torch.utils.compiled import compiled
from frenetix_tpu_torch.utils.config import FrenetixConfig

__all__ = ["PlannedTrajectory", "ReactivePlanner", "wants_stopping_mode"]


def wants_stopping_mode(stop_point, x_cl, threshold: float) -> bool:
    """Switch to end-position-constrained (quintic) longitudinal sampling:
    a stop point is armed, its target velocity is below `threshold` and a
    deceleration demand, and the point lies ahead of the ego."""
    return (
        stop_point is not None
        and stop_point[1] < threshold
        and stop_point[0] > x_cl[0][0]
        and stop_point[1] < max(float(x_cl[0][1]), 1.0) + 2.0
    )


@dataclass
class PlannedTrajectory:
    """The selected trajectory on the host (NumPy): Cartesian and curvilinear
    states plus the sampling parameters that produced it."""

    x: np.ndarray
    y: np.ndarray
    theta: np.ndarray
    v: np.ndarray
    a: np.ndarray
    kappa: np.ndarray
    s: np.ndarray
    s_dot: np.ndarray
    s_ddot: np.ndarray
    d: np.ndarray
    d_dot: np.ndarray
    d_ddot: np.ndarray
    cost: float
    sampling_parameters: np.ndarray  # (13,)
    mode: str = "optimal"  # optimal | stopping_plan | standstill | stopping | min_risk
    cost_terms: Optional[np.ndarray] = None
    # set when debug.log_risk is on and there are predicted obstacles
    ego_risk: Optional[float] = None
    obst_risk: Optional[float] = None

    @property
    def steering_angle(self) -> np.ndarray:
        """The steering angles set by `compute_steering`."""
        return self._steering

    def compute_steering(self, wheelbase: float):
        """Kinematic steering angles arctan(wheelbase · κ); returns self."""
        self._steering = np.arctan2(wheelbase * self.kappa, 1.0)
        return self

    def yaw_rate(self, dt: float, yaw_rate0: float = 0.0) -> np.ndarray:
        """Yaw rates by central differences of θ over `dt`, the first one
        set to `yaw_rate0`."""
        yr = np.gradient(self.theta) / dt
        yr[0] = yaw_rate0
        return yr


_STATE_ROWS = ("x", "y", "theta_gl", "v", "a", "kappa_gl",
               "s", "s_vel", "s_acc", "d", "d_vel", "d_acc")


def _selected_rows(ro, cost, terms, idx: torch.Tensor, length: int) -> list[torch.Tensor]:
    """The candidate `idx`'s 12 state rows and its [cost, cost_terms...] row,
    each padded to `length`, gathered without a host sync (idx is a (1,)
    device tensor)."""
    n1 = ro.x.shape[1]
    k = terms.shape[1]
    pad = length - n1
    rows = [torch.nn.functional.pad(torch.index_select(getattr(ro, f), 0, idx)[0],
                                    (0, pad))
            for f in _STATE_ROWS]
    extra = torch.cat([torch.index_select(cost, 0, idx),
                       torch.index_select(terms, 0, idx)[0]])
    rows.append(torch.nn.functional.pad(extra, (0, length - 1 - k)))
    return rows


@compiled
def _select_rows(ro, cost, terms, idx: torch.Tensor) -> torch.Tensor:
    """(13, L) tensor: the candidate `idx`'s 12 state rows and its
    [cost, cost_terms...] row, L = max(N+1, 1+K); one program (JAX's
    `_jitted_select_rows`)."""
    length = max(ro.x.shape[1], 1 + terms.shape[1])
    return torch.stack(_selected_rows(ro, cost, terms, idx, length))


@compiled
def _replan_pack(res, mask: torch.Tensor) -> torch.Tensor:
    """(14, L) tensor: header [found, best_idx, feasible, collisions, off_road,
    histogram...], the selected candidate's 12 state rows and its
    [cost, cost_terms...] row.  Counters and indices are < 2^24, so they
    survive float32 exactly.  The rows are garbage when found is False."""
    ro = res.rollout
    dtype = ro.x.dtype
    k = res.cost_terms.shape[1]
    n1 = ro.x.shape[1]
    h = res.histogram.shape[0]
    length = max(n1, 1 + k, 5 + h)
    header = torch.cat([
        torch.stack([
            res.found.to(dtype),
            res.best_idx.to(dtype),
            torch.sum(ro.feasible & mask).to(dtype),
            torch.sum(res.collides & mask).to(dtype),
            torch.sum((res.boundary_step >= 0) & mask).to(dtype),
        ]),
        res.histogram.to(dtype),
    ])
    header = torch.nn.functional.pad(header, (0, length - 5 - h))
    idx = res.best_idx.reshape(1).long()
    return torch.stack([header, *_selected_rows(ro, res.cost, res.cost_terms, idx,
                                                length)])


@compiled(static=("w", "dt", "mass"))
def _responsibility(ro, preds, meta, grid, cost, selectable, best0, *, w, dt, mass):
    """Responsibility re-selection on the device: risk stack → reach-grid
    term → cost + w·term → argmin over `selectable` again (first index on
    ties; `best0` stays where nothing is selectable).  Returns (cost, best);
    nothing is copied to the host."""
    risks = trajectory_risks(ro, preds, meta, mass)
    cost2 = cost + w * responsibility_reach_grid(ro, grid, risks, dt)
    masked = torch.where(selectable, cost2, torch.full_like(cost2, torch.inf))
    best = torch.where(torch.any(selectable, dim=-1), torch.argmin(masked, dim=-1),
                       best0.long()).to(torch.int32)
    return cost2, best


@compiled(static=("dt", "veh", "thresholds", "w_pm", "w_um", "w_ve"))
def _occlusion_pack(res, preds, meta, phantom_mask, ego, r_vis, pts, pts_valid, *,
                    dt, veh, thresholds, w_pm, w_um, w_ve) -> torch.Tensor:
    """The occlusion-gated re-selection of one level as ONE (14, L) tensor:
    header [found, idx, selection cost, ego_risk, obst_risk], the selected
    candidate's 12 state rows and its [cost, cost_terms...] row.  Risk stack,
    the shared `phantom_safety_mask`, the soft cost terms and the masked
    argmin all run on the device.  The rows are garbage when found is
    False."""
    ro = res.rollout
    risks = trajectory_risks(ro, preds, meta, veh.mass)
    safe = phantom_safety_mask(risks, phantom_mask, thresholds,
                               rollout=ro, preds=preds, veh=veh, dt=dt)
    sel = res.selectable & safe
    cost2 = res.cost
    if w_pm != 0.0 or w_um != 0.0 or w_ve != 0.0:
        cost2 = cost2 + external_occlusion_costs(
            ro, w_pm=w_pm, w_um=w_um, w_ve=w_ve, risks=risks,
            phantom_mask=phantom_mask, ego=ego, r_vis=r_vis,
            occluder_pts=pts, occluder_valid=pts_valid)
    masked = torch.where(sel, cost2, torch.full_like(cost2, torch.inf))
    idx = torch.argmin(masked).reshape(1)
    length = max(ro.x.shape[1], 1 + res.cost_terms.shape[1], 5)
    header = torch.cat([
        torch.any(sel).to(cost2.dtype).reshape(1),
        idx.to(cost2.dtype),
        torch.index_select(cost2, 0, idx),
        torch.index_select(risks.ego_risk, 0, idx),
        torch.index_select(risks.obst_risk, 0, idx),
    ])
    header = torch.nn.functional.pad(header, (0, length - 5))
    return torch.stack([header,
                        *_selected_rows(ro, cost2, res.cost_terms, idx, length)])


@compiled(static=("mass",))
def _risk_program(ro, preds, meta, *, mass):
    """((M,) ego_risk + obst_risk, the TrajectoryRisks) of a rollout over the
    full risk stack; one program (JAX's jitted `_risk_fn`)."""
    risks = trajectory_risks(ro, preds, meta, mass)
    return risks.ego_risk + risks.obst_risk, risks


class ReactivePlanner:
    def __init__(self, config: FrenetixConfig, device: torch.device, msg_logger=None):
        if config.planning.emergency_mode not in ("stopping", "min_risk"):
            raise ValueError(
                f"planning.emergency_mode={config.planning.emergency_mode!r}: "
                "expected 'stopping' or 'min_risk'")
        if config.planning.sampling_min >= config.planning.sampling_max:
            raise ValueError(
                f"planning.sampling_min ({config.planning.sampling_min}) must "
                f"be < planning.sampling_max ({config.planning.sampling_max}) "
                "— the max bound is exclusive"
            )
        self.config = config
        self.msg_logger = msg_logger
        self.device = torch.device(device)
        self.dtype = torch.float64 if config.dtype == "float64" else torch.float32
        self.np_dtype = np.float64 if config.dtype == "float64" else np.float32
        self.veh = config.vehicle
        self.dt = config.planning.dt
        self.n_steps = config.planning.n_steps
        self.horizon = config.planning.planning_horizon

        self.weights = self._tensor(np.array(
            [config.cost_weights.get(k, 0.0) for k in COST_TERM_ORDER]))
        self.ref = None
        self.ref_np = None
        self.corridor = None
        self.preds = None
        self.obstacle_meta = None
        self.obstacle_xy = np.zeros((0, 2), self.np_dtype)
        self.obstacle_valid = np.zeros((0,), bool)
        self.desired_velocity = 0.0
        self.desired_avg_velocity = 0.0
        self.stop_point: Optional[tuple[float, float]] = None  # (s, v)
        self.occlusion_module = None
        self.phantom_mask = None
        self._occ_ego_state = None
        self._occ_time_step = None
        self.reach_grid = None   # lanelet reach sets (responsibility cost)
        # gated levels of all plan calls, how many of them changed the
        # level's first choice, and how many rejected every candidate
        self.gate_stats = {"levels": 0, "changed": 0, "rejected_all": 0}
        self.current_velocity = 0.0
        self.infeasible_histogram = np.zeros(11, int)
        self.last_cycle = None  # (CycleResult, matrix, mask) with save_all_traj
        self.stats = {}

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ setup
    def set_reference_path(self, polyline: np.ndarray, drivable_polygons=None,
                           lanelets=None):
        """Reference tables, drivable corridor and lane-center segments from a
        raw route polyline; the tables go to the planner's device."""
        ref = prepare_reference_path(polyline, smooth=True, dtype=self.np_dtype)
        self.ref_np = ref
        if drivable_polygons:
            corridor = corridor_from_polygons(ref, drivable_polygons)
        else:
            corridor = strip_corridor(ref, 3.5 + self.veh.width)
        self.corridor = self._tensor(corridor.astype(self.np_dtype))
        self.ref = RefPathTable(*(self._tensor(f) for f in ref))

        segs = []
        for ll in (lanelets or []):
            cv = np.asarray(ll.center_vertices, self.np_dtype)
            segs.append(np.stack([cv[:-1], cv[1:]], axis=1))
        if segs:
            seg_arr = np.concatenate(segs, axis=0)
            self.lane_segments = self._tensor(seg_arr)
            self.lane_valid = torch.ones(len(seg_arr), dtype=torch.bool,
                                         device=self.device)
        else:
            self.lane_segments = torch.zeros((0, 2, 2), dtype=self.dtype,
                                             device=self.device)
            self.lane_valid = torch.zeros((0,), dtype=torch.bool, device=self.device)

    def set_predictions(self, preds, obstacle_meta=None):
        """`obstacle_meta`: a risk.harm.ObstacleMeta for the rows of `preds`;
        without one the risk stack infers mass and protection from the
        footprints."""
        self.preds = preds
        self.obstacle_meta = obstacle_meta

    def set_obstacles(self, obstacle_xy: np.ndarray, obstacle_valid: np.ndarray):
        self.obstacle_xy = obstacle_xy.astype(self.np_dtype)
        self.obstacle_valid = obstacle_valid

    def set_desired_velocity(self, v_des: float, v_avg: float = None):
        self.desired_velocity = float(v_des)
        self.desired_avg_velocity = float(v_avg if v_avg is not None else v_des)

    def set_stop_point(self, stop_s, stop_v):
        self.stop_point = (float(stop_s), float(stop_v)) if stop_s is not None else None

    def set_reach_grid(self, grid):
        """Lanelet-following reach sets (a risk.reachable_set.ReachSetGrid
        on the planner's device) for the responsibility cost."""
        self.reach_grid = grid

    def set_occlusion_module(self, module, phantom_mask=None, ego_state=None,
                             time_step=None):
        """Arm the occlusion gate: `phantom_mask` (O,) bool marks the phantom
        rows of the predictions; `ego_state` and `time_step` feed the soft
        cost terms (occ_um needs the polar visibility map around the pose)."""
        self.occlusion_module = module
        self.phantom_mask = phantom_mask
        self._occ_ego_state = ego_state
        self._occ_time_step = time_step

    # ---------------------------------------------------------------- planning
    def compute_initial_state(self, x0):
        """Cartesian rear-axle state → curvilinear ((s, ṡ, s̈), (d, ḋ, d̈)),
        on the host in NumPy (`compute_initial_state_np`), with the lateral
        derivatives over arclength below `planning.low_vel_mode_threshold`."""
        low_vel = float(x0.velocity) < self.config.planning.low_vel_mode_threshold
        return compute_initial_state_np(self.ref_np, x0, self.veh.wheelbase, low_vel)

    def _sampling_ranges(self, level: int, x_cl):
        p = self.config.planning
        x0_lon, x0_lat = x_cl
        t1 = smp.time_samples(p.t_min, self.horizon, self.dt, level)
        t1 = np.unique(np.concatenate([t1, [self.n_steps * self.dt]]))
        v_min = max(0.001, self.current_velocity - self.veh.a_max * self.horizon)
        v_max = min(self.current_velocity + (self.veh.a_max / 6.0) * self.horizon,
                    self.veh.v_max)
        ss1 = np.union1d(smp.linspace_samples(v_min, v_max, level), [x0_lon[1]])
        if p.d_ego_pos:
            d_lo, d_hi = x0_lat[0] + p.d_min, x0_lat[0] + p.d_max
        else:
            d_lo, d_hi = p.d_min, p.d_max
        d1 = np.union1d(smp.linspace_samples(d_lo, d_hi, level), [x0_lat[0]])
        return t1, ss1, d1

    def _make_context(self, x0_orientation) -> CycleContext:
        preds = self.preds
        if preds is None:
            preds = empty_predictions(self.n_steps, self.dtype, self.device)
        return CycleContext(
            ref=self.ref,
            veh=self.veh,
            weights=self.weights,
            preds=preds,
            obstacle_xy=self._tensor(self.obstacle_xy),
            obstacle_valid=self._tensor(self.obstacle_valid, torch.bool),
            corridor=self.corridor,
            lane_segments=self.lane_segments,
            lane_valid=self.lane_valid,
            x0_orientation=self._tensor(x0_orientation),
            desired_velocity=self._tensor(self.desired_velocity),
            desired_avg_velocity=self._tensor(self.desired_avg_velocity),
        )

    def plan(self, x0, x_cl) -> Optional[PlannedTrajectory]:
        """One replanning cycle.

        x0: rear-axle Cartesian state (x, y, orientation, velocity,
        acceleration, steering_angle); x_cl: ((s, ṡ, s̈), (d, ḋ, d̈)).
        Returns the selected PlannedTrajectory, or None."""
        p = self.config.planning
        self.current_velocity = float(x0.velocity)
        low_vel = self.current_velocity < p.low_vel_mode_threshold
        ctx = self._make_context(float(x0.orientation))

        optimal = None
        last_res, last_matrix, last_mask, last_pack = None, None, None, None
        level = p.sampling_min
        use_stopping = wants_stopping_mode(
            self.stop_point, x_cl, self.config.behavior.stopping_mode_threshold
        )
        while optimal is None and level < p.sampling_max:
            quintic_lon = False
            if use_stopping:
                matrix = self._stopping_matrix(level, x_cl)
                quintic_lon = True
            else:
                t1, ss1, d1 = self._sampling_ranges(level, x_cl)
                matrix = smp.build_sampling_matrix(
                    t1_vals=t1, ss1_vals=ss1, d1_vals=d1,
                    x0_lon=x_cl[0], x0_lat=x_cl[1], dtype=self.np_dtype,
                )
            matrix, mask = smp.pad_matrix(matrix, self.config.debug.matrix_bucket)
            mask_t = self._tensor(mask, torch.bool)
            res = evaluate_cycle(
                self._tensor(matrix), mask_t, ctx,
                dt=self.dt, n_steps=self.n_steps, low_vel_mode=low_vel,
                quintic_lon=quintic_lon,
                compensated_sum=p.compensated_cost_sum,
            )
            res = self._apply_responsibility(res)
            last_res, last_matrix, last_mask = res, matrix, mask
            # the ONE device→host copy of this level
            pack = _replan_pack(res, mask_t).cpu().numpy().astype(self.np_dtype)
            last_pack = pack
            found = bool(pack[0, 0])
            mode = "stopping_plan" if quintic_lon else "optimal"
            occ_ok = True
            if (self.occlusion_module is not None and self.phantom_mask is not None
                    and found):
                # occlusion gate: select again among the candidates whose
                # phantom metrics stay under the thresholds; one more copy.
                # Its header carries the SELECTION cost (with the soft
                # terms), so this path and the batched one log the same
                pack_o = self._occlusion_pack(res, ctx)
                self.gate_stats["levels"] += 1
                if bool(pack_o[0, 0]):
                    self.gate_stats["changed"] += int(pack_o[0, 1] != pack[0, 1])
                    optimal = self._plan_from_rows(
                        pack_o[1:], res, int(pack_o[0, 1]), matrix, mode,
                        cost_override=float(pack_o[0, 2]),
                        risk_scalars=(float(pack_o[0, 3]), float(pack_o[0, 4])))
                else:
                    self.gate_stats["rejected_all"] += 1
                    occ_ok = False
            if optimal is None and occ_ok and found:
                optimal = self._plan_from_rows(pack[1:], res, int(pack[0, 1]),
                                               matrix, mode)
            if optimal is None and use_stopping:
                # stopping sampling found nothing → regular sampling, same level
                use_stopping = False
                continue
            level += 1

        h = int(last_res.histogram.shape[0])
        header = last_pack[0]
        self.infeasible_histogram = header[5:5 + h].astype(np.int64)
        if self.config.debug.save_all_traj:
            # kept on the device; the trajectory logger copies it once
            self.last_cycle = (last_res, last_matrix, last_mask)
        self.stats = {
            "feasible": int(header[2]),
            "total": int(last_mask.sum()),
            "collisions": int(header[3]),
            "off_road": int(header[4]),
        }

        if optimal is not None:
            return optimal

        # ---- fallback ladder ------------------------------------------------
        if self.current_velocity <= 0.1:
            return self._standstill_trajectory(x0, x_cl)
        ro = last_res.rollout
        feas = (ro.feasible & ro.valid).cpu().numpy() & last_mask
        if feas.any():
            if p.emergency_mode == "stopping":
                idx = self._select_stopping_index(last_matrix, feas, x_cl[1][0])
                return self._materialize(last_res, idx, last_matrix, "stopping")
            # minimum-risk selection: lowest ego_risk + obst_risk among the
            # feasible candidates, first index on ties
            total, risks = self._risk_totals(ro)
            total = torch.where(self._tensor(feas, torch.bool), total,
                                torch.full_like(total, torch.inf))
            return self._materialize(last_res, int(torch.argmin(total)),
                                     last_matrix, "min_risk", risks=risks)
        return None

    # ------------------------------------------------------------------ risk
    def _default_meta(self, preds):
        """The obstacles' crash metadata: what `set_predictions` was given,
        else mass and protection class inferred from the footprints."""
        if self.obstacle_meta is not None:
            return self.obstacle_meta
        return meta_from_footprint(preds.lengths, preds.widths)

    def _risk_totals(self, ro):
        """((M,) ego_risk + obst_risk on the device, the TrajectoryRisks) of
        a rollout; zeros and None without predicted obstacles."""
        preds = self.preds
        if preds is None or preds.num_obstacles == 0:
            return torch.zeros(ro.x.shape[0], dtype=self.dtype,
                               device=self.device), None
        return _risk_program(ro, preds, self._default_meta(preds), mass=self.veh.mass)

    def _apply_responsibility(self, res):
        """Add the reach-set responsibility term to the level's costs and
        select again; active only with a non-zero weight, a reach grid and
        predicted obstacles."""
        w = self.config.cost_weights.get("responsibility", 0.0)
        if w == 0.0 or self.reach_grid is None or self.preds is None \
                or self.preds.num_obstacles == 0:
            return res
        cost2, best = _responsibility(
            res.rollout, self.preds, self._default_meta(self.preds),
            self.reach_grid, res.cost, res.selectable, res.best_idx,
            w=w, dt=self.dt, mass=self.veh.mass)
        return res._replace(cost=cost2, best_idx=best)

    def _occlusion_pack(self, res, ctx) -> np.ndarray:
        """The gated re-selection of this level on the host, (14, L): the
        host work is gathering the polar map and the phantoms' silhouette
        points for the soft cost terms."""
        mod = self.occlusion_module
        ew = self.config.external_cost_weights
        w_pm = float(ew.get("occ_pm", 0.0))
        w_um = float(ew.get("occ_um", 0.0))
        w_ve = float(ew.get("occ_ve", 0.0))
        ego_state = self._occ_ego_state
        if ego_state is not None and w_um != 0.0:
            r_vis, ego = mod.polar_map(ego_state, self._occ_time_step)
        else:
            r_vis = np.full(720, float(mod.sensor_radius))
            ego = (np.asarray(ego_state.position, dtype=np.float64)
                   if ego_state is not None else np.zeros(2))
        if w_ve != 0.0 or w_um != 0.0 or w_pm != 0.0:
            pts, pts_valid = mod.occluder_points()
        else:
            pts, pts_valid = np.zeros((1, 2)), np.zeros(1, bool)
        pack = _occlusion_pack(
            res, ctx.preds, self._default_meta(ctx.preds),
            self._tensor(self.phantom_mask, torch.bool), self._tensor(ego),
            self._tensor(r_vis), self._tensor(pts),
            self._tensor(pts_valid, torch.bool),
            dt=self.dt, veh=self.veh, thresholds=mod.thresholds,
            w_pm=w_pm, w_um=w_um, w_ve=w_ve)
        return pack.cpu().numpy().astype(self.np_dtype)

    def _stopping_matrix(self, level: int, x_cl):
        """End-position-constrained sampling matrix t1 × s1 × d1 with end
        velocity 0; column 5 carries the end position (quintic_lon mode)."""
        p = self.config.planning
        stop_s, stop_v = self.stop_point
        x0_lon, x0_lat = x_cl

        d_delta = 0.4
        d_thresh = 5.0
        ref_vel = (x0_lon[1] + stop_v) / 2.0
        if ref_vel < d_thresh:
            d_delta = max((x0_lon[1] / d_thresh) * d_delta, 0.01)

        t1 = smp.time_samples(p.t_min, self.horizon, self.dt, level)
        t1 = np.unique(np.concatenate([t1, [self.n_steps * self.dt]]))
        s1 = smp.linspace_samples((x0_lon[0] + stop_s) / 2.0, stop_s, level)
        d1 = np.union1d(
            smp.linspace_samples(x0_lat[0] - d_delta, x0_lat[0] + d_delta,
                                 max(level - 1, 0)),
            [x0_lat[0]],
        )
        return smp.build_sampling_matrix(
            t1_vals=t1, ss1_vals=s1, d1_vals=d1,
            x0_lon=x0_lon, x0_lat=x0_lat, dtype=self.np_dtype,
        )

    # ------------------------------------------------------------- fallbacks
    @staticmethod
    def _select_stopping_index(matrix, feasible_mask, d_pos) -> int:
        """Order by v ascending, then t ascending, then |d - current d|; the
        first feasible candidate wins."""
        v = matrix[:, 5]
        t = matrix[:, 1]
        d = matrix[:, 10]
        d_rank_vals = np.unique(d)
        d_rank = {val: r for r, val in
                  enumerate(d_rank_vals[np.argsort(np.abs(d_rank_vals - d_pos))])}
        order = np.lexsort((np.array([d_rank[val] for val in d]), t, v))
        for i in order:
            if feasible_mask[i]:
                return int(i)
        return int(order[0])

    def _standstill_trajectory(self, x0, x_cl) -> PlannedTrajectory:
        """Constant-pose trajectory with an initial braking pulse."""
        n1 = self.n_steps + 1

        def rep(v):
            return np.full(n1, v, self.np_dtype)

        a = np.zeros(n1, self.np_dtype)
        if n1 > 1:
            a[1] = -x0.velocity / self.dt
        kappa0 = np.tan(float(x0.steering_angle)) / self.veh.wheelbase
        row = np.zeros(13, self.np_dtype)
        row[1] = self.horizon
        row[2:5] = x_cl[0]
        row[7:10] = x_cl[1]
        row[10] = x_cl[1][0]
        return PlannedTrajectory(
            x=rep(float(x0.x)), y=rep(float(x0.y)), theta=rep(float(x0.orientation)),
            v=rep(0.0), a=a, kappa=rep(kappa0),
            s=rep(x_cl[0][0]), s_dot=rep(x_cl[0][1]), s_ddot=rep(x_cl[0][2]),
            d=rep(x_cl[1][0]), d_dot=rep(x_cl[1][1]), d_ddot=rep(x_cl[1][2]),
            cost=0.0, sampling_parameters=row, mode="standstill",
        )

    # ---------------------------------------------------------- materialization
    def _materialize(self, res, idx: int, matrix, mode: str,
                     risks=None) -> PlannedTrajectory:
        """Candidate `idx` to the host in one copy; `risks`, when the caller
        already has the rollout's TrajectoryRisks, saves `log_risk` from
        computing them again."""
        index = torch.tensor([idx], device=self.device)
        rows = _select_rows(res.rollout, res.cost, res.cost_terms, index)
        return self._plan_from_rows(rows.cpu().numpy().astype(self.np_dtype),
                                    res, idx, matrix, mode, risks=risks)

    def _plan_from_rows(self, rows, res, idx: int, matrix, mode: str, risks=None,
                        cost_override=None, risk_scalars=None) -> PlannedTrajectory:
        """PlannedTrajectory from host rows: 12 state rows + [cost, terms...].
        With `debug.log_risk` and predicted obstacles, the selected
        candidate's risks come from the full risk stack over the rollout,
        or from `risk_scalars` (ego_risk, obst_risk) where the caller has
        already copied them."""
        k = res.cost_terms.shape[1]
        n1 = res.rollout.x.shape[1]
        (x, y, theta, v, a_, kappa, s, s_dot, s_ddot, d, d_dot, d_ddot) = (
            r[:n1] for r in rows[:12])
        extra = rows[12]
        plan = PlannedTrajectory(
            x=x, y=y, theta=theta, v=v, a=a_, kappa=kappa,
            s=s, s_dot=s_dot, s_ddot=s_ddot,
            d=d, d_dot=d_dot, d_ddot=d_ddot,
            cost=float(extra[0]) if cost_override is None else float(cost_override),
            sampling_parameters=np.asarray(matrix[idx]),
            mode=mode,
            cost_terms=extra[1:1 + k],
        )
        if (self.config.debug.log_risk and self.preds is not None
                and self.preds.num_obstacles > 0):
            if risk_scalars is not None:
                plan.ego_risk, plan.obst_risk = risk_scalars
                return plan
            if risks is None:
                _, risks = self._risk_totals(res.rollout)
            pair = torch.stack([risks.ego_risk[idx], risks.obst_risk[idx]])
            plan.ego_risk, plan.obst_risk = (float(v) for v in pair.cpu())
        return plan
