"""Occlusion module: phantom agents at occlusion boundaries + safety gating.

PyTorch port of `frenetix_tpu/occlusion/occlusion_module.py`:

  - spawn locator (host NumPy): occlusion boundary points behind static and
    dynamic obstacles (the shadow edge as seen from the ego) and behind
    turns of the route,
  - agent manager (host NumPy): phantom pedestrians / bicycles / vehicles at
    the spawn points, with constant-velocity predictions of inflated
    uncertainty toward the ego's corridor,
  - safety assessment (torch, on the rollout's device): phantom rows are
    appended to the cycle's PredictionTensors, so the batched risk stack
    prices them; candidates whose phantom metrics break the configured
    thresholds are excluded from selection (`phantom_safety_mask`), and the
    soft terms price what stays (`external_occlusion_costs`).

The two tensor functions take leading agent axes; every sum over obstacles
adds the slots one by one, so a batched result equals the sequential one.
Off by default (`occlusion.use_occlusion_module`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from frenetix_tpu_torch.risk.costs import sum_obstacles

__all__ = ["PHANTOM_TYPES", "PhantomSpec", "OcclusionModule", "PhantomThresholds",
           "phantom_safety_mask", "external_occlusion_costs"]

# per-type phantom parameters
PHANTOM_TYPES = {
    "pedestrian": dict(velocity=1.4, length=0.3, width=0.5),
    "bicycle": dict(velocity=5.0, length=2.0, width=0.9),
    "car": dict(velocity=10.0, length=4.8, width=2.0),
    "truck": dict(velocity=10.0, length=9.0, width=2.5),
}


class PhantomThresholds(NamedTuple):
    """Metric thresholds of the gate; None = metric deactivated.

    `harm` / `risk` / `cp` / `be` are severity metrics: a candidate is unsafe
    when the metric EXCEEDS its threshold.  `ttc` / `wttc` / `ttce` / `dce`
    are criticality metrics (smaller = worse): unsafe when the metric falls
    BELOW its threshold.  The defaults are the default gate (harm 0.1,
    risk 1, everything else off)."""

    harm: Optional[float] = 0.1
    risk: Optional[float] = 1.0
    cp: Optional[float] = None
    ttc: Optional[float] = None
    wttc: Optional[float] = None
    ttce: Optional[float] = None
    dce: Optional[float] = None
    be: Optional[float] = None

    @staticmethod
    def from_config(occ_cfg) -> "PhantomThresholds":
        t = dict(occ_cfg.metric_thresholds or {})
        unknown = set(t) - set(PhantomThresholds._fields)
        if unknown:
            # a misspelled threshold key must not silently leave the gate at
            # its defaults
            raise ValueError(
                f"unknown occlusion metric threshold(s) {sorted(unknown)}; "
                f"valid: {list(PhantomThresholds._fields)}"
            )
        t.setdefault("harm", occ_cfg.harm_threshold)
        t.setdefault("risk", occ_cfg.risk_threshold)
        return PhantomThresholds(**{
            k: (None if t.get(k) is None else float(t[k]))
            for k in PhantomThresholds._fields
        })


def _on(x, like, dtype=None):
    """`x` (tensor, array or number) as a tensor on `like`'s device."""
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def phantom_safety_mask(risks, phantom_mask, thresholds: PhantomThresholds,
                        *, rollout=None, preds=None, veh=None, dt=0.1,
                        a_max=8.0):
    """(..., M) bool safe-mask of the candidates against the PHANTOM obstacle
    rows, per the activated metric thresholds.  The one definition shared by
    the sequential gate (`ReactivePlanner.plan`) and the batched cycle
    (`parallel.mesh.batched_full_cycle`); `phantom_mask` is (..., O) bool.

    Metrics against each phantom's mean trajectory:
      harm: expected phantom harm (harm × collision probability; raw harm
            alone would reject any moving candidate however unlikely the
            encounter), per phantom;
      risk: the same, summed over phantoms;
      cp:   max-over-time collision probability, per phantom;
      dce:  distance of closest encounter (center distance, min over time);
      ttce: time of the closest encounter;
      ttc:  first time the center distance enters the combined enclosing
            circles (1e9 = never);
      wttc: worst-case ttc: the phantom additionally closes a_max·t²/2
            (it may accelerate toward the ego);
      be:   constant braking needed to stop before the closest-encounter
            gap, in m/s².

    `rollout`, `preds` and `veh` are needed only when a geometric metric
    (ttc, wttc, ttce, dce, be) is activated."""
    per_obst = risks.obst_risk_per_obst
    pmr = _on(phantom_mask, per_obst, torch.bool)[..., None, :]     # (..., 1, O)
    safe = None

    def also(s, c):
        return c if s is None else s & c

    phantom_risk = torch.where(pmr, per_obst, torch.zeros_like(per_obst))
    if thresholds.harm is not None:
        safe = also(safe, torch.all(phantom_risk <= thresholds.harm, dim=-1))
    if thresholds.risk is not None:
        safe = also(safe, sum_obstacles(phantom_risk) <= thresholds.risk)
    if thresholds.cp is not None:
        cp = torch.where(pmr, risks.coll_prob_per_obst,
                         torch.zeros_like(risks.coll_prob_per_obst))
        safe = also(safe, torch.all(cp <= thresholds.cp, dim=-1))

    geom = (thresholds.ttc, thresholds.wttc, thresholds.ttce, thresholds.dce,
            thresholds.be)
    if any(g is not None for g in geom):
        x = rollout.x
        # a fill, not a host scalar: no host→device copy (CUDA-graph capture)
        big = torch.full((), 1e9, dtype=x.dtype, device=x.device)
        n = min(x.shape[-1] - 1, preds.means.shape[-2])
        ex, ey = x[..., :, None, 1:n + 1], rollout.y[..., :, None, 1:n + 1]
        px = preds.means[..., None, :, :n, 0]
        py = preds.means[..., None, :, :n, 1]
        d = torch.hypot(ex - px, ey - py)                        # (..., M, O, n)
        d = torch.where(pmr[..., None], d, big)
        t = torch.arange(1, n + 1, dtype=x.dtype, device=x.device) * dt
        # contact radius of the two enclosing circles, (..., 1, O)
        r = 0.5 * (torch.hypot(preds.lengths, preds.widths)
                   + math.hypot(veh.length, veh.width))[..., None, :]
        d_min, i_ce = torch.min(d, dim=-1)     # first minimum over time
        if thresholds.dce is not None:
            dce = torch.where(pmr, d_min, big)
            safe = also(safe, torch.all(dce >= thresholds.dce, dim=-1))
        if thresholds.ttce is not None:
            tce = torch.where(pmr, t[i_ce], big)
            safe = also(safe, torch.all(tce >= thresholds.ttce, dim=-1))
        if thresholds.ttc is not None:
            hit = d <= r[..., None]
            ttc = torch.amin(torch.where(hit, t, big), dim=-1)
            safe = also(safe, torch.all(ttc >= thresholds.ttc, dim=-1))
        if thresholds.wttc is not None:
            hit = d <= r[..., None] + 0.5 * a_max * t ** 2
            wttc = torch.amin(torch.where(hit, t, big), dim=-1)
            safe = also(safe, torch.all(wttc >= thresholds.wttc, dim=-1))
        if thresholds.be is not None:
            v_ce = torch.gather(
                rollout.v[..., :, None, 1:n + 1].expand(d.shape), -1,
                i_ce[..., None])[..., 0]
            gap = torch.clamp(d_min - r, min=0.5)
            be = torch.where(pmr, v_ce ** 2 / (2.0 * gap), torch.zeros_like(gap))
            safe = also(safe, torch.all(be <= thresholds.be, dim=-1))

    if safe is None:
        return torch.ones(per_obst.shape[:-1], dtype=torch.bool,
                          device=per_obst.device)
    return safe


def external_occlusion_costs(rollout, *, w_pm=0.0, w_um=0.0, w_ve=0.0,
                             risks=None, phantom_mask=None, ego=None,
                             r_vis=None, occluder_pts=None,
                             occluder_valid=None):
    """(..., M) soft occlusion cost terms (`external_cost_weights`), batched
    over candidates and leading agent axes:

      occ_pm: phantom module, the expected harm against phantom rows
              (Σ over phantoms of harm × collision probability),
      occ_um: uncertainty map, the mean depth of trajectory points BEYOND
              the visible range of their ray (distance into unobserved
              space, from the polar visibility map `r_vis` (..., K) around
              `ego` (..., 2)),
      occ_ve: visibility estimator, an exponential-decay proximity to the
              occluder silhouette points `occluder_pts` (..., Q, 2): lateral
              clearance from occluders widens the visible wedge, so
              closeness is penalized.
    """
    xs = rollout.x
    dtype, device = xs.dtype, xs.device
    cost = torch.zeros(xs.shape[:-1], dtype=dtype, device=device)
    if w_pm and risks is not None and phantom_mask is not None:
        pm = _on(phantom_mask, xs, torch.bool)[..., None, :]
        per_obst = risks.obst_risk_per_obst
        cost = cost + w_pm * sum_obstacles(
            torch.where(pm, per_obst, torch.zeros_like(per_obst)))
    if occluder_pts is not None:
        occluder_pts = _on(occluder_pts, xs, dtype)
    use_um = bool(w_um) and r_vis is not None
    use_ve = bool(w_ve) and occluder_pts is not None and occluder_pts.shape[-2] > 0
    if use_um or use_ve:
        if ego is None:
            raise ValueError("occ_um/occ_ve require the ego position")
        ego = _on(ego, xs, dtype)
        ex, ey = ego[..., 0, None, None], ego[..., 1, None, None]
        x, y = xs[..., 1:], rollout.y[..., 1:]                   # (..., M, N)
    if use_um:
        r_vis = _on(r_vis, xs, dtype)
        k = r_vis.shape[-1]
        d = torch.hypot(x - ex, y - ey)
        ang = torch.atan2(y - ey, x - ex)
        # nearest-ray lookup as in VisibleArea.r_at: ties round to even
        idx = torch.round((ang + math.pi) / (2.0 * math.pi) * k).long() % k
        r_ray = torch.gather(r_vis[..., None, :].expand(x.shape[:-1] + (k,)), -1, idx)
        depth = torch.clamp(d - r_ray, min=0.0)
        cost = cost + w_um * torch.mean(depth, dim=-1)
    if use_ve:
        dq = torch.hypot(x[..., :, None, :] - occluder_pts[..., None, :, 0, None],
                         y[..., :, None, :] - occluder_pts[..., None, :, 1, None])
        if occluder_valid is not None:                           # (..., M, Q, N)
            valid = _on(occluder_valid, xs, torch.bool)
            dq = torch.where(valid[..., None, :, None], dq,
                             torch.full((), 1e9, dtype=dtype, device=device))
        d_near = torch.amin(dq, dim=-2)                          # (..., M, N)
        cost = cost + w_ve * torch.mean(torch.exp(-d_near / 2.0), dim=-1)
    return cost


@dataclass
class PhantomSpec:
    position: np.ndarray
    heading: float
    agent_type: str = "pedestrian"


@dataclass
class OcclusionModule:
    """One agent's occlusion module (host NumPy): spawn points, phantom
    prediction rows, and the geometry inputs of the soft cost terms."""

    scenario: object
    sensor_radius: float = 50.0
    max_phantoms: int = 4
    harm_threshold: float = 0.1
    risk_threshold: float = 1.0
    variance_factor: float = 1.05
    phantom_type: str = "pedestrian"
    # full metric gate (None → built from the two thresholds above)
    thresholds: Optional[PhantomThresholds] = None
    # which occlusion sources get phantom spawn points, and how many each
    spawn_point_behind_dynamic_obstacle: bool = True
    spawn_point_behind_static_obstacle: bool = True
    spawn_points_behind_turn: bool = False
    max_dynamic_spawn_points: int = 4
    max_static_spawn_points: int = 4
    # size inflation of the phantoms
    size_factor_length: float = 1.2
    size_factor_width: float = 1.3
    # reference path for turn spawn points (set by the owning agent)
    route_xy: Optional[np.ndarray] = None
    # geometry context of the gate's geometric metrics
    veh: object = None
    dt: float = 0.1
    # set per step by the owning simulation: ids of obstacles that became
    # agents (their recorded trajectories are stale) and the live poses
    # (position, orientation, length, width) that occlude in their place
    occluder_exclude: frozenset = frozenset()
    extra_occluders: tuple = ()
    _last_phantoms: list = field(default_factory=list)
    _polar_cache_key: Optional[tuple] = None
    _polar_cache: Optional[tuple] = None

    def __post_init__(self):
        if self.thresholds is None:
            self.thresholds = PhantomThresholds(harm=self.harm_threshold,
                                                risk=self.risk_threshold)

    # ------------------------------------------------------------ spawn points
    def find_spawn_points(self, ego_state, time_step, route_xy=None):
        """Occlusion boundary points: for each obstacle between the ego and
        its shadow, the points just past the obstacle's silhouette edges;
        optionally a point behind the next turn of the route (the unseen
        inside of a street corner).  Returns up to `max_phantoms`
        PhantomSpecs, nearest first, within the per-category caps."""
        ego = np.asarray(ego_state.position, dtype=float)
        dyn, stat = [], []
        for ob in self.scenario.obstacles.values():
            is_dynamic = getattr(ob, "role", "dynamic") == "dynamic"
            if is_dynamic and not self.spawn_point_behind_dynamic_obstacle:
                continue
            if not is_dynamic and not self.spawn_point_behind_static_obstacle:
                continue
            st = ob.state_at_time(time_step)
            if st is None:
                continue
            d_vec = np.asarray(st.position) - ego
            dist = float(np.hypot(*d_vec))
            if dist < 2.0 or dist > self.sensor_radius:
                continue
            ray = d_vec / dist
            # silhouette edge: offset perpendicular to the view ray by the
            # obstacle's half extent, then step behind the obstacle
            perp = np.array([-ray[1], ray[0]])
            half = max(ob.length, ob.width) / 2.0
            for side in (+1.0, -1.0):
                p = np.asarray(st.position) + side * perp * (half + 0.5) + ray * 1.0
                # the phantom walks toward the ego's forward corridor
                heading = float(np.arctan2(-side * perp[1], -side * perp[0]))
                (dyn if is_dynamic else stat).append(
                    (dist, PhantomSpec(p, heading, self.phantom_type)))
        dyn.sort(key=lambda x: x[0])
        stat.sort(key=lambda x: x[0])
        specs = (dyn[: self.max_dynamic_spawn_points]
                 + stat[: self.max_static_spawn_points])
        if self.spawn_points_behind_turn:
            specs += self._turn_spawn_points(ego, route_xy)
        specs.sort(key=lambda x: x[0])
        self._last_phantoms = [s for _, s in specs[: self.max_phantoms]]
        return self._last_phantoms

    def _turn_spawn_points(self, ego, route_xy=None, kappa_threshold=0.03):
        """A spawn point on the unseen inside of the next turn of the route:
        at the nearest high-curvature route point within sensor range, one
        lane width toward the turn's center, heading across the ego's path."""
        xy = route_xy if route_xy is not None else self.route_xy
        if xy is None or len(xy) < 5:
            return []
        xy = np.asarray(xy, dtype=float)
        seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        dx, dy = np.gradient(xy[:, 0], s), np.gradient(xy[:, 1], s)
        ddx, ddy = np.gradient(dx, s), np.gradient(dy, s)
        kappa = (dx * ddy - dy * ddx) / np.maximum(
            (dx * dx + dy * dy) ** 1.5, 1e-12)
        dist = np.linalg.norm(xy - ego[None], axis=1)
        ahead = (dist > 5.0) & (dist < self.sensor_radius)
        hot = np.where(ahead & (np.abs(kappa) > kappa_threshold))[0]
        if len(hot) == 0:
            return []
        i = int(hot[np.argmin(dist[hot])])
        normal = np.array([-dy[i], dx[i]])
        normal /= max(np.linalg.norm(normal), 1e-9)
        inside = normal * np.sign(kappa[i])        # toward the turn's center
        p = xy[i] + 3.6 * inside
        heading = float(np.arctan2(-inside[1], -inside[0]))
        return [(float(dist[i]), PhantomSpec(p, heading, self.phantom_type))]

    # --------------------------------------------------------------- phantoms
    def phantom_prediction_rows(self, specs, horizon, dt, dtype=np.float32):
        """PredictionTensors field rows of the phantom agents (constant
        velocity along their heading, inflated covariance)."""
        params = PHANTOM_TYPES[self.phantom_type]
        o = len(specs)
        means = np.zeros((o, horizon, 2), dtype)
        covs = np.zeros((o, horizon, 2, 2), dtype)
        orientations = np.zeros((o, horizon), dtype)
        velocities = np.full((o, horizon), params["velocity"], dtype)
        steps = np.arange(1, horizon + 1)
        for k, sp in enumerate(specs):
            heading = np.array([np.cos(sp.heading), np.sin(sp.heading)])
            means[k] = sp.position[None] + (
                params["velocity"] * dt * steps
            )[:, None] * heading[None]
            orientations[k] = sp.heading
            var = (0.3 + 0.2 * steps * dt) * self.variance_factor
            covs[k, :, 0, 0] = var
            covs[k, :, 1, 1] = var
        inv = np.linalg.inv(covs.astype(np.float64)).astype(dtype)
        return dict(
            means=means, covs=covs, inv_covs=inv, orientations=orientations,
            velocities=velocities,
            lengths=np.full(o, params["length"] * self.size_factor_length, dtype),
            widths=np.full(o, params["width"] * self.size_factor_width, dtype),
            valid=np.ones((o, horizon), bool),
        )

    def augment_predictions(self, pd, ego_state, time_step, dt):
        """Write phantom rows into free slots of a prediction dict; returns
        (pd, number of phantoms written)."""
        specs = self.find_spawn_points(ego_state, time_step)
        if not specs:
            return pd, 0
        horizon = pd["means"].shape[1]
        rows = self.phantom_prediction_rows(specs, horizon, dt, pd["means"].dtype)
        free = np.where(~pd["valid"].any(axis=1))[0]
        n = min(len(free), len(specs))
        for j in range(n):
            slot = free[j]
            for key in ("means", "covs", "inv_covs", "orientations",
                        "velocities", "lengths", "widths", "valid"):
                pd[key][slot] = rows[key][j]
        return pd, n

    # ------------------------------------------------- external-cost inputs
    def polar_map(self, ego_state, time_step, n_rays: int = 720):
        """(r_vis (K,), ego (2,)): the polar visibility map around the ego
        from obstacle shadows within sensor range (the input of occ_um).
        Road walls are left out on purpose: off-road space is the boundary
        check's business, not priced as unobserved.

        Obstacles in `occluder_exclude` are skipped and `extra_occluders`
        occlude in their place, as in the sensor path.  Cached per
        time step (the sampling levels of one plan call reuse it)."""
        key = (int(time_step), n_rays)
        if self._polar_cache_key == key:
            return self._polar_cache
        # imported here: `frenetix_tpu_torch.sim` re-exports the simulation,
        # which imports this module through the agent
        from frenetix_tpu_torch.sim.visible_area import obstacle_obb_segments, polar_visibility

        ego = np.asarray(ego_state.position, dtype=np.float64)
        segs = []
        for ob in self.scenario.obstacles.values():
            if ob.obstacle_id in self.occluder_exclude:
                continue
            st = ob.state_at_time(time_step)
            if st is None:
                continue
            # extent margin: a body reaching into range occludes even when
            # its center is just outside
            if (np.linalg.norm(np.asarray(st.position) - ego)
                    > self.sensor_radius + max(ob.length, ob.width)):
                continue
            segs.append(obstacle_obb_segments(
                st.position, st.orientation, ob.length, ob.width))
        for pos, theta, length, width in self.extra_occluders:
            if (np.linalg.norm(np.asarray(pos) - ego)
                    > self.sensor_radius + max(length, width)):
                continue
            segs.append(obstacle_obb_segments(pos, theta, length, width))
        segs = (np.concatenate(segs, axis=0) if segs
                else np.zeros((0, 2, 2)))
        _, r_vis = polar_visibility(ego, segs, self.sensor_radius, n_rays)
        self._polar_cache_key = key
        self._polar_cache = (r_vis, ego)
        return r_vis, ego

    def occluder_points(self):
        """(Q, 2) silhouette points of the current phantoms, padded, and the
        (Q,) valid mask (the input of occ_ve); Q = max_phantoms always, so
        the tensors keep one shape."""
        q = self.max_phantoms
        pts = np.zeros((q, 2))
        valid = np.zeros(q, bool)
        for i, sp in enumerate(self._last_phantoms[:q]):
            pts[i] = sp.position
            valid[i] = True
        return pts, valid

    # -------------------------------------------------------------- assessment
    def trajectory_safety_assessment(self, risks, phantom_mask, rollout=None,
                                     preds=None):
        """(M,) bool safe-mask per the module's thresholds: the shared
        `phantom_safety_mask` with this module's vehicle and dt."""
        return phantom_safety_mask(
            risks, phantom_mask, self.thresholds,
            rollout=rollout, preds=preds, veh=self.veh, dt=self.dt,
        )
