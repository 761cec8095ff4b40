"""Criticality metrics: per-agent, per-timestep measures.

The port's own NumPy copy of `frenetix_tpu/evaluation/metrics.py`: the
CommonRoad criticality set HW, THW, TTC, TIT, TET, DCE, TTCE, a_long_req,
BTN, a_lat_req, STN, ET, PET, MSD, PSD, jerk(/lat/long), acc(/lat/long),
v(/lat/long), enabled per metric by `evaluation.criticality_metrics`.

Computed post hoc on the host over the recorded state history.  The
leading-vehicle search projects ego and obstacles onto curvilinear frames of
the ego's lanelet successor chains (Δs minus orientation-projected
half-lengths), with an ego-frame corridor fallback when the scenario has no
lanelet network.  ET/PET use lanelet conflict areas from the intersection
elements: the conflict region is the overlap of the ego's and the obstacle's
merged successor-lane polygons, with entering and exit times from OBB-sample
membership.

`Measures.compute` returns a `MetricTable` where the JAX package returns a
pandas DataFrame (the machines the port runs on need not have pandas): the
same index (time steps), columns and values.
"""
from __future__ import annotations

import numpy as np

from frenetix_tpu_torch.behavior.frame import HostFrame
from frenetix_tpu_torch.io.commonroad import _point_in_ring

__all__ = ["CRITICALITY_METRICS", "Measures", "MetricTable", "enabled_metrics"]

CRITICALITY_METRICS = [
    "hw", "thw", "ttc", "tit", "tet", "dce", "ttce", "a_long_req", "btn",
    "a_lat_req", "stn", "et", "pet", "msd", "psd", "jerk", "jerk_lat",
    "jerk_long", "acc", "a_lat", "a_long", "v", "v_lat", "v_long",
]


class MetricTable:
    """Metric columns over the time steps: `index` (the time steps),
    `columns` (the metric names, in order), `table[name]` (one NumPy
    column) and `iterrows()` ((time step, {name: value}) per row)."""

    def __init__(self, data: dict, index):
        self.index = np.asarray(index)
        self.columns = list(data)
        self._data = {k: np.asarray(v) for k, v in data.items()}

    def __getitem__(self, name):
        return self._data[name]

    def __len__(self):
        return len(self.index)

    def iterrows(self):
        for i, ts in enumerate(self.index):
            yield ts, {k: v[i] for k, v in self._data.items()}


def enabled_metrics(toggles) -> list:
    """CRITICALITY_METRICS filtered by an evaluation.yaml enable map;
    unknown metric names raise (a typo'd toggle must not silently leave the
    real metric enabled)."""
    toggles = toggles or {}
    unknown = set(toggles) - set(CRITICALITY_METRICS)
    if unknown:
        raise ValueError(
            f"unknown criticality metric(s) {sorted(unknown)}; "
            f"valid: {CRITICALITY_METRICS}"
        )
    return [m for m in CRITICALITY_METRICS if toggles.get(m, True)]


class Measures:
    """Computes all enabled metrics for one agent over its history.

    states: list of EgoState (position, orientation, velocity, acceleration,
    yaw_rate, time_step); obstacle trajectories come from the scenario plus
    the other agents' histories.
    """

    def __init__(self, agent_id, scenario, states, other_histories=None, *,
                 dt=0.1, a_max_long=11.5, a_max_lat=8.0, radius=100.0, tau=2.0,
                 lane_halfwidth=1.75, veh_length=4.508, veh_width=1.61):
        self.agent_id = agent_id
        self.scenario = scenario
        self.states = states
        self.dt = dt
        self.a_max_long = a_max_long
        self.a_max_lat = a_max_lat
        self.radius = radius
        self.tau = tau
        self.lane_halfwidth = lane_halfwidth
        self.veh_length = veh_length
        self.veh_width = veh_width

        self.t_steps = np.array([s.time_step for s in states])
        self.pos = np.array([s.position for s in states])          # (T, 2)
        self.theta = np.array([s.orientation for s in states])
        self.vel = np.array([s.velocity for s in states])
        self.acc_arr = np.array([s.acceleration for s in states])
        self.yaw_rate = np.array([getattr(s, "yaw_rate", 0.0) for s in states])

        self._others = self._collect_others(other_histories or {})
        self._lead = None
        self._dist = None

    # ------------------------------------------------------------- obstacles
    def _collect_others(self, other_histories):
        """Per-timestep (position, velocity, orientation) of every other
        traffic participant within `radius` (metrics.py:95-115)."""
        out = []
        agent_ids = set(other_histories.keys())
        for ob in self.scenario.dynamic_obstacles:
            if ob.obstacle_id == self.agent_id or ob.obstacle_id in agent_ids:
                continue
            out.append(("obs", ob))
        for aid, hist in other_histories.items():
            if aid != self.agent_id:
                out.append(("agent", hist))
        return out

    def _other_state(self, entry, t):
        kind, data = entry
        if kind == "obs":
            return data.state_at_time(t)
        for s in data:
            if s.time_step == t:
                return s
        return None

    def _relative_states(self):
        """(T, O, 4): [dist, rel_long, rel_lat, v_obs] per step; NaN if absent."""
        if self._dist is not None:
            return self._dist
        t_len = len(self.states)
        o = len(self._others)
        rel = np.full((t_len, o, 4), np.nan)
        for ti, t in enumerate(self.t_steps):
            c, s = np.cos(self.theta[ti]), np.sin(self.theta[ti])
            for oi, entry in enumerate(self._others):
                st = self._other_state(entry, int(t))
                if st is None:
                    continue
                d = np.asarray(st.position) - self.pos[ti]
                dist = float(np.hypot(d[0], d[1]))
                if dist > self.radius:
                    continue
                rel[ti, oi] = [dist, d[0] * c + d[1] * s, -d[0] * s + d[1] * c,
                               st.velocity]
        self._dist = rel
        return rel

    def _ego_chain_frames(self):
        """Curvilinear frames over the ego's lanelet successor chains
        (every branch; the reference's `self.cosys` built from
        all_lanelets_by_merging_successors, metrics.py:72-84, 158-174).
        Returns [(HostFrame, set(lanelet_ids))]; [] without a network."""
        if getattr(self, "_chains", None) is not None:
            return self._chains
        self._chains = []
        lanelets = getattr(self.scenario, "lanelets", None)
        if not lanelets:
            return self._chains
        start_ids = self.scenario.find_lanelets_by_position(self.pos[0])
        chains: list[list[int]] = []

        def walk(chain, length):
            ll = lanelets.get(chain[-1])
            succ = [s for s in (ll.successors if ll else [])
                    if s in lanelets and s not in chain]
            if not succ or length > self.radius:
                chains.append(chain)
                return
            for s in succ:
                seg = lanelets[s].center_vertices
                seg_len = float(np.linalg.norm(np.diff(seg, axis=0), axis=1).sum())
                walk(chain + [s], length + seg_len)

        for sid in start_ids:
            walk([sid], 0.0)
        for chain in chains:
            pts = np.concatenate(
                [lanelets[l].center_vertices for l in chain], axis=0
            )
            keep = np.concatenate(
                [[True], np.linalg.norm(np.diff(pts, axis=0), axis=1) > 1e-9]
            )
            try:
                self._chains.append((HostFrame(pts[keep]), set(chain)))
            except Exception:
                continue
        return self._chains

    @staticmethod
    def _projected_half_length(theta_cl, length, width):
        """Silhouette half-length along the lane direction
        (metrics.py:286-289)."""
        return (abs(length / 2 * np.cos(theta_cl))
                + abs(width / 2 * np.sin(theta_cl)))

    def _leading(self):
        """Per-step headway/velocity of the closest obstacle ahead on any of
        the ego's lanelet chains — curvilinear Δs minus the orientation-
        projected half-lengths (hw(), metrics.py:258-297).  Falls back to the
        ego-frame corridor when the scenario has no lanelet network."""
        if self._lead is not None:
            return self._lead
        chains = self._ego_chain_frames()
        t_len = len(self.states)
        if chains:
            hw = np.full(t_len, np.inf)
            v_lead = np.zeros(t_len)
            ego_s = {}
            ego_th = {}
            for ci, (frame, _ids) in enumerate(chains):
                s, _d = frame.project(self.pos)
                ego_s[ci] = s
                # local orientation of the ego on this chain
                ds = np.maximum(frame.s[1] - frame.s[0], 1e-9)
                idx = np.clip((s / ds).astype(int), 0, len(frame.theta) - 1)
                ego_th[ci] = self.theta - frame.theta[idx]
            for ti in range(t_len):
                t = int(self.t_steps[ti])
                for entry in self._others:
                    st = self._other_state(entry, t)
                    if st is None:
                        continue
                    p_obs = np.asarray(st.position)
                    if np.linalg.norm(p_obs - self.pos[ti]) > self.radius:
                        continue
                    obs_ids = set(self.scenario.find_lanelets_by_position(p_obs))
                    if not obs_ids:
                        continue
                    ob = entry[1] if entry[0] == "obs" else None
                    l_o = ob.length if ob is not None else self.veh_length
                    w_o = ob.width if ob is not None else self.veh_width
                    for ci, (frame, ids) in enumerate(chains):
                        if not (obs_ids & ids):
                            continue
                        s_obs, _ = frame.project(p_obs)
                        ds = np.maximum(frame.s[1] - frame.s[0], 1e-9)
                        k = int(np.clip(s_obs / ds, 0, len(frame.theta) - 1))
                        th_obs = st.orientation - frame.theta[k]
                        gap = (
                            s_obs - ego_s[ci][ti]
                            - self._projected_half_length(th_obs, l_o, w_o)
                            - self._projected_half_length(
                                ego_th[ci][ti], self.veh_length, self.veh_width)
                        )
                        if 0 < gap < hw[ti]:
                            hw[ti] = gap
                            v_lead[ti] = st.velocity
            self._lead = (hw, v_lead)
            return self._lead
        # fallback: ego-frame corridor (no lanelet network)
        rel = self._relative_states()
        ahead = (rel[:, :, 1] > 0) & (np.abs(rel[:, :, 2]) < self.lane_halfwidth)
        long_gap = np.where(ahead, rel[:, :, 1], np.inf)
        idx = np.argmin(long_gap, axis=1) if rel.shape[1] else np.zeros(t_len, int)
        hw = np.take_along_axis(long_gap, idx[:, None], axis=1)[:, 0] if rel.shape[1] else np.full(t_len, np.inf)
        v_obs = np.take_along_axis(rel[:, :, 3], idx[:, None], axis=1)[:, 0] if rel.shape[1] else np.zeros(t_len)
        hw = hw - self.veh_length  # bumper-to-bumper
        self._lead = (hw, v_obs)
        return self._lead

    # ------------------------------------------------------------- kinematic
    def v(self):
        return self.vel.copy()

    def v_long(self):
        return self.vel * np.cos(0.0)  # slip-free single-track assumption

    def v_lat(self):
        """Lateral velocity from the heading-relative position increments."""
        out = np.zeros_like(self.vel)
        if len(self.pos) > 1:
            d = np.diff(self.pos, axis=0) / self.dt
            lat = -d[:, 0] * np.sin(self.theta[:-1]) + d[:, 1] * np.cos(self.theta[:-1])
            out[1:] = lat
        return out

    def a_long(self):
        return self.acc_arr.copy()

    def a_lat(self):
        return self.vel * self.yaw_rate

    def acc(self):
        return np.hypot(self.a_long(), self.a_lat())

    def jerk_long(self):
        out = np.zeros_like(self.acc_arr)
        out[1:] = np.diff(self.a_long()) / self.dt
        return out

    def jerk_lat(self):
        out = np.zeros_like(self.acc_arr)
        out[1:] = np.diff(self.a_lat()) / self.dt
        return out

    def jerk(self):
        return np.hypot(self.jerk_long(), self.jerk_lat())

    # ------------------------------------------------------------ criticality
    def hw(self):
        return self._leading()[0]

    def thw(self):
        hw, _ = self._leading()
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.vel > 0.1, hw / self.vel, np.inf)

    def ttc(self):
        hw, v_obs = self._leading()
        closing = self.vel - v_obs
        with np.errstate(divide="ignore", invalid="ignore"):
            ttc = np.where((closing > 0.1) & np.isfinite(hw), hw / closing, np.inf)
        return np.maximum(ttc, 0.0)

    def tet(self):
        """Time exposed TTC from each step onward: future-cumulative
        Σ dt over steps with TTC ≤ tau, normalized by episode length
        (metrics.py:475-488)."""
        exposed = (self.ttc() <= self.tau).astype(float) * self.dt
        future = np.cumsum(exposed[::-1])[::-1]
        span = max(len(self.states) - 1, 1)
        return future / span

    def tit(self):
        """Time integrated TTC from each step onward: future-cumulative
        Σ (tau − TTC)·dt over steps with TTC ≤ tau (metrics.py:460-473)."""
        ttc = self.ttc()
        contrib = np.where(ttc <= self.tau, (self.tau - ttc) * self.dt, 0.0)
        contrib = np.where(np.isfinite(contrib), contrib, 0.0)
        return np.cumsum(contrib[::-1])[::-1]

    def _future_min_distance(self):
        """(dce (T,), t_of_min (T,)) — minimum inter-vehicle distance over the
        FUTURE [t, end] and the step it occurs at (metrics.py:410-442)."""
        rel = self._relative_states()
        t_len = len(self.states)
        if rel.shape[1] == 0:
            return np.full(t_len, np.inf), np.full(t_len, np.inf)
        d = np.nanmin(np.where(np.isnan(rel[:, :, 0]), np.inf, rel[:, :, 0]), axis=1)
        dce = np.empty(t_len)
        t_min = np.empty(t_len)
        best, best_t = np.inf, np.inf
        for i in range(t_len - 1, -1, -1):
            if d[i] < best:
                best, best_t = d[i], self.t_steps[i]
            dce[i] = best
            t_min[i] = best_t
        return dce, t_min

    def dce(self):
        """Distance of closest encounter over the future from each step
        (reversed running min, metrics.py:410-442)."""
        return self._future_min_distance()[0]

    def ttce(self):
        """Time until the future closest encounter from each step
        ((t_min_dce − t)·dt, metrics.py:444-458)."""
        dce, t_min = self._future_min_distance()
        with np.errstate(invalid="ignore"):
            return np.where(
                np.isfinite(t_min), (t_min - self.t_steps) * self.dt, np.inf
            )

    def a_long_req(self):
        """Deceleration required to match the leader's speed within the gap:
        -(Δv)²/(2·hw)."""
        hw, v_obs = self._leading()
        closing = np.maximum(self.vel - v_obs, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            req = np.where(
                np.isfinite(hw) & (hw > 0.1), -(closing**2) / (2.0 * hw), 0.0
            )
        return req

    def btn(self):
        return np.abs(self.a_long_req()) / self.a_max_long

    def a_lat_req(self):
        """Lateral acceleration needed to clear the leader laterally within
        TTC: 2·w_clear / TTC²."""
        ttc = self.ttc()
        w_clear = self.veh_width  # half widths of both vehicles, approximately
        with np.errstate(divide="ignore", invalid="ignore"):
            req = np.where(np.isfinite(ttc) & (ttc > 1e-3), 2.0 * w_clear / ttc**2, 0.0)
        return req

    def stn(self):
        return self.a_lat_req() / self.a_max_lat

    def msd(self):
        """Minimum stopping distance v²/(2·a_max)."""
        return self.vel**2 / (2.0 * self.a_max_long)

    def psd(self):
        """Proportion of stopping distance: remaining gap / MSD."""
        hw, _ = self._leading()
        msd = self.msd()
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(msd > 0.1, hw / msd, np.inf)

    # --------------------------------------------- intersection conflict areas
    def _intersection_successor_lanelets(self) -> list:
        """Lanelets that are successors of any intersection incoming
        (metrics.py:620-624)."""
        out = []
        for inter in getattr(self.scenario, "intersections", []):
            for inc in inter.incomings:
                out.extend(inc.successors_left + inc.successors_right
                           + inc.successors_straight)
        return out

    def _vehicle_lane_rings(self, positions, intersec_lanelets):
        """The merged successor chain a vehicle fully drives on, restricted
        to chains touching the intersection — returned as its lanelet rings
        (the `_obs_lane_poly` merged polygon, metrics.py:236-256; membership
        in the merged polygon = membership in any constituent ring)."""
        lanelets = self.scenario.lanelets
        start_ids = self.scenario.find_lanelets_by_position(positions[0])
        best = None
        for sid in start_ids:
            # depth-first successor chains from this start lanelet
            stack = [[sid]]
            while stack:
                chain = stack.pop()
                ll = lanelets.get(chain[-1])
                succ = [s for s in (ll.successors if ll else [])
                        if s in lanelets and s not in chain]
                total_len = sum(
                    float(np.linalg.norm(np.diff(lanelets[c].center_vertices, axis=0), axis=1).sum())
                    for c in chain
                )
                if succ and total_len < self.radius:
                    stack.extend(chain + [s] for s in succ)
                    continue
                if not (set(chain) & set(intersec_lanelets)):
                    continue
                rings = [lanelets[c].polygon for c in chain]
                contains_all = all(
                    any(_point_in_ring(np.asarray(p), r) for r in rings)
                    for p in positions
                )
                if contains_all:
                    best = rings
                    break
            if best:
                break
        return best

    @staticmethod
    def _obb_samples(position, orientation, length, width, n_l=5, n_w=3):
        """Sample points covering a vehicle OBB (footprint-membership probes)."""
        xs = np.linspace(-length / 2, length / 2, n_l)
        ys = np.linspace(-width / 2, width / 2, n_w)
        gx, gy = np.meshgrid(xs, ys)
        local = np.stack([gx.ravel(), gy.ravel()], axis=1)
        c, s = np.cos(orientation), np.sin(orientation)
        rot = np.array([[c, -s], [s, c]])
        return local @ rot.T + np.asarray(position)

    def _in_conflict_area(self, position, orientation, length, width,
                          rings_a, rings_b) -> bool:
        """Vehicle shape intersects (A ∩ B)?  Probed by footprint samples in
        BOTH merged-lane polygons — the reference's
        `veh_shape.intersects(ego_poly ∩ obs_poly)` without constructing the
        intersection (metrics.py:209-233)."""
        pts = self._obb_samples(position, orientation, length, width)
        for p in pts:
            if any(_point_in_ring(p, r) for r in rings_a) and \
                    any(_point_in_ring(p, r) for r in rings_b):
                return True
        return False

    def _ca_times(self, rings_a, rings_b, traj_fn, length, width):
        """Enter/exit steps of a vehicle w.r.t. the conflict area
        (metrics.py:209-233): enter = step before first contact, exit =
        first step after contact ends."""
        enter, exit_, inside = np.inf, np.inf, False
        for t in range(int(self.t_steps[0]), int(self.t_steps[-1]) + 1):
            st = traj_fn(t)
            if st is None:
                continue
            hit = self._in_conflict_area(
                st.position, st.orientation, length, width, rings_a, rings_b
            )
            if hit and not inside:
                enter, inside = max(t - 1, 0), True
            if not hit and inside:
                exit_ = t
                break
        return enter, exit_

    def _conflict_results(self):
        """[(et, ego_enter, pet, pet_step)] per obstacle sharing a conflict
        area with the ego (et(), pet(), metrics.py:613-727)."""
        if getattr(self, "_ca_cache", None) is not None:
            return self._ca_cache
        self._ca_cache = []
        intersec = self._intersection_successor_lanelets()
        if not intersec:
            return self._ca_cache
        ego_rings = self._vehicle_lane_rings(self.pos, intersec)
        if not ego_rings:
            return self._ca_cache

        def ego_traj(t):
            idx = np.where(self.t_steps == t)[0]
            return self.states[int(idx[0])] if len(idx) else None

        for entry in self._others:
            if entry[0] != "obs":
                continue
            ob = entry[1]
            traj_pts = [np.asarray(s.position)
                        for s in [ob.initial_state] + ob.trajectory]
            obs_rings = self._vehicle_lane_rings(traj_pts, intersec)
            if not obs_rings:
                continue
            ego_in, ego_out = self._ca_times(
                ego_rings, obs_rings, ego_traj, self.veh_length, self.veh_width
            )
            obs_in, obs_out = self._ca_times(
                ego_rings, obs_rings, ob.state_at_time, ob.length, ob.width
            )
            # guard BEFORE subtracting: inf - inf = NaN would poison min()
            et = ego_out - ego_in if np.isfinite(ego_in) and np.isfinite(ego_out) \
                else np.inf
            if np.isinf(ego_in) or np.isinf(ego_out) or np.isinf(obs_in) \
                    or np.isinf(obs_out):
                pet, pet_step = np.inf, np.inf
            elif obs_in > ego_out:
                pet, pet_step = abs(obs_in - ego_out), ego_out
            elif ego_in > obs_out:
                pet, pet_step = abs(ego_in - obs_out), obs_out
            else:
                pet, pet_step = 0, 0
            self._ca_cache.append((et, ego_in, pet, pet_step))
        return self._ca_cache

    def et(self):
        """Encroachment time: steps the ego needs to cross the lanelet
        conflict area, counting down while inside (metrics.py:613-664).
        inf without intersections — reference parity."""
        out = np.full(len(self.states), np.inf)
        res = self._conflict_results()
        if not res:
            return out
        et, t_start, _, _ = min(res)
        for ti, t in enumerate(self.t_steps):
            if t <= t_start:
                out[ti] = et
            elif t <= t_start + et:
                out[ti] = et - (t - t_start)
        return out

    def pet(self):
        """Post-encroachment time: steps between one vehicle leaving and the
        other entering the shared conflict area (metrics.py:666-727)."""
        out = np.full(len(self.states), np.inf)
        res = self._conflict_results()
        if not res:
            return out
        best = min(res, key=lambda r: (r[2], r[3]))
        _, _, pet, pet_step = best
        for ti, t in enumerate(self.t_steps):
            if t <= pet_step:
                out[ti] = pet
        return out

    def compute(self, metrics=None):
        """→ MetricTable indexed by time_step; a metric that raises is a
        column of NaN."""
        metrics = CRITICALITY_METRICS if metrics is None else metrics
        data = {}
        for m in metrics:
            try:
                data[m] = getattr(self, m)()
            except Exception:
                data[m] = np.full(len(self.states), np.nan)
        return MetricTable(data, index=self.t_steps)
