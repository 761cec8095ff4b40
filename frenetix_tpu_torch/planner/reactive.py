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

Features this slice does not carry raise NotImplementedError at
construction, naming the ROADMAP.md slice that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from frenetix_tpu_torch.geometry.corridor import corridor_from_polygons, strip_corridor
from frenetix_tpu_torch.geometry.refpath import RefPathTable, prepare_reference_path
from frenetix_tpu_torch.ops import sampling as smp
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER, empty_predictions
from frenetix_tpu_torch.planner.core import CycleContext, evaluate_cycle
from frenetix_tpu_torch.risk.costs import trajectory_risks
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.utils.config import FrenetixConfig

__all__ = ["PlannedTrajectory", "ReactivePlanner", "wants_stopping_mode"]


def _unsupported_features(config: FrenetixConfig) -> list[str]:
    """Enabled features of `config` that the port does not carry yet, each
    with the ROADMAP.md slice that brings it."""
    out = []
    if config.cost_weights.get("responsibility", 0.0) != 0.0:
        out.append("cost_weights.responsibility != 0 (responsibility: slice 3b)")
    if config.occlusion.use_occlusion_module:
        out.append("occlusion.use_occlusion_module (occlusion: slice 4)")
    if config.behavior.use_behavior_planner:
        out.append("behavior.use_behavior_planner (behavior planner: slice 6)")
    return out


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


_STATE_ROWS = ("x", "y", "theta_gl", "v", "a", "kappa_gl",
               "s", "s_vel", "s_acc", "d", "d_vel", "d_acc")


def _selected_rows(res, idx: torch.Tensor, length: int) -> list[torch.Tensor]:
    """The candidate `idx`'s 12 state rows and its [cost, cost_terms...] row,
    each padded to `length`, gathered without a host sync (idx is a (1,)
    device tensor)."""
    ro = res.rollout
    n1 = ro.x.shape[1]
    k = res.cost_terms.shape[1]
    pad = length - n1
    rows = [torch.nn.functional.pad(torch.index_select(getattr(ro, f), 0, idx)[0],
                                    (0, pad))
            for f in _STATE_ROWS]
    extra = torch.cat([torch.index_select(res.cost, 0, idx),
                       torch.index_select(res.cost_terms, 0, idx)[0]])
    rows.append(torch.nn.functional.pad(extra, (0, length - 1 - k)))
    return rows


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
    return torch.stack([header, *_selected_rows(res, idx, length)])


class ReactivePlanner:
    def __init__(self, config: FrenetixConfig, device: torch.device):
        unsupported = _unsupported_features(config)
        if unsupported:
            raise NotImplementedError(
                "not yet ported to frenetix_tpu_torch: " + "; ".join(unsupported))
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
        self.current_velocity = 0.0
        self.infeasible_histogram = np.zeros(11, int)
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

    # ---------------------------------------------------------------- planning
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
            last_res, last_matrix, last_mask = res, matrix, mask
            # the ONE device→host copy of this level
            pack = _replan_pack(res, mask_t).cpu().numpy().astype(self.np_dtype)
            last_pack = pack
            if bool(pack[0, 0]):
                mode = "stopping_plan" if quintic_lon else "optimal"
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
        risks = trajectory_risks(ro, preds, self._default_meta(preds), self.veh.mass)
        return risks.ego_risk + risks.obst_risk, risks

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
        n1 = res.rollout.x.shape[1]
        length = max(n1, 1 + res.cost_terms.shape[1])
        index = torch.tensor([idx], device=self.device)
        rows = torch.stack(_selected_rows(res, index, length))
        return self._plan_from_rows(rows.cpu().numpy().astype(self.np_dtype),
                                    res, idx, matrix, mode, risks=risks)

    def _plan_from_rows(self, rows, res, idx: int, matrix,
                        mode: str, risks=None) -> PlannedTrajectory:
        """PlannedTrajectory from host rows: 12 state rows + [cost, terms...].
        With `debug.log_risk` and predicted obstacles, the selected
        candidate's risks come from the full risk stack over the rollout."""
        k = res.cost_terms.shape[1]
        n1 = res.rollout.x.shape[1]
        (x, y, theta, v, a_, kappa, s, s_dot, s_ddot, d, d_dot, d_ddot) = (
            r[:n1] for r in rows[:12])
        extra = rows[12]
        plan = PlannedTrajectory(
            x=x, y=y, theta=theta, v=v, a=a_, kappa=kappa,
            s=s, s_dot=s_dot, s_ddot=s_ddot,
            d=d, d_dot=d_dot, d_ddot=d_ddot,
            cost=float(extra[0]),
            sampling_parameters=np.asarray(matrix[idx]),
            mode=mode,
            cost_terms=extra[1:1 + k],
        )
        if (self.config.debug.log_risk and self.preds is not None
                and self.preds.num_obstacles > 0):
            if risks is None:
                _, risks = self._risk_totals(res.rollout)
            pair = torch.stack([risks.ego_risk[idx], risks.obst_risk[idx]])
            plan.ego_risk, plan.obst_risk = (float(v) for v in pair.cpu())
        return plan
