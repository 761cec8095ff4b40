"""The behavior FSM inside the device-resident run.

PyTorch port of `frenetix_tpu/behavior/device_fsm.py`.  The host behavior
planner (`behavior_module.BehaviorModule.execute` with its FSM and velocity
planner) is sequential control logic; for the scope below it becomes one
torch function of the run's body: states are int32 codes, transitions are
`torch.where` cascades evaluated per agent, and every world query of the host
FSM (current lanelet, preceding vehicle, stop-line clearance, traffic-light
state) is a precomputed table (recorded obstacles, light schedules, static
route goals) or a tensor computation over the live agents.  The function
reads nothing on the host, so the body keeps its one fetch per run and
captures into a CUDA graph.

Supported scope (`build_fsm_tensors` returns supported=False otherwise and
the run takes the hybrid path, the host FSM between device cycles):
  - static-route goals StaticDefault, (Prepare)TrafficLight,
    (Prepare)StopSign, (Prepare)YieldSign, (Prepare)Crosswalk (turns,
    intersections, lane merges and road exits use the host FSM's
    lane-conflict clearance walk);
  - no navigation lane changes, and one street setting over all lanelets;
  - dynamic layer DynamicDefault: the wish to overtake (`EgoFSM.
    _should_overtake`) is detected and raises the carried `bail` flag, and
    the run is done again on the hybrid path.

The tables are built in float64 on the host (the host FSM works on float64
`HostFrame`s) and cast to the run's type.  Every function takes any leading
axes before the agent axis (a fleet's scenario axis).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from frenetix_tpu_torch.behavior.fsm import _NO_CROSS
from frenetix_tpu_torch.behavior.path_planner import consecutive_lanelet_chain
from frenetix_tpu_torch.io.commonroad import speed_limit_for_lanelets

__all__ = ["FSMTensors", "FSMCarry", "build_fsm_tensors", "fsm_carry0",
           "make_fsm_step", "pad_fsm_tensors"]

# goal-type codes (behavior_state_static)
T_DEFAULT, T_TL_PREP, T_TL, T_STOP_PREP, T_STOP, T_YIELD_PREP, T_YIELD, \
    T_CROSS_PREP, T_CROSS = 0, 1, 2, 3, 4, 5, 6, 7, 8

_TYPE_CODE = {
    "StaticDefault": T_DEFAULT,
    "PrepareTrafficLight": T_TL_PREP, "TrafficLight": T_TL,
    "PrepareStopSign": T_STOP_PREP, "StopSign": T_STOP,
    "PrepareYieldSign": T_YIELD_PREP, "YieldSign": T_YIELD,
    "PrepareCrosswalk": T_CROSS_PREP, "Crosswalk": T_CROSS,
}

# situation codes (situation_state_static, family-generic)
S_NONE, S_OBSERVE, S_SLOWING, S_GREEN, S_STOPPING, S_WAITING, S_CONTINUE, \
    S_CLEAR = 0, 1, 2, 3, 4, 5, 6, 7

# traffic-light state codes
TL_OTHER, TL_GREEN, TL_REDYELLOW = 0, 1, 2

_DEFAULT_SPEED_LIMIT = {
    "Highway": 130 / 3.6, "Country": 100 / 3.6, "Urban": 50 / 3.6,
}


def _leaf_to(a, device, dtype):
    """One host leaf as a tensor: floats as `dtype`, masks and codes kept."""
    a = np.require(np.asarray(a), requirements="C")
    if a.dtype.kind == "f":
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


class _Leaves:
    """Leaf-wise helpers of the two dataclasses below."""

    def to(self, device, dtype):
        """The same structure as tensors on `device` (floats as `dtype`)."""
        return self.map(lambda a: _leaf_to(a, device, dtype))

    def map(self, fn, *rest):
        """`fn` over the corresponding leaves of this and `rest`."""
        return type(self)(**{f.name: fn(getattr(self, f.name),
                                        *(getattr(r, f.name) for r in rest))
                             for f in fields(self)})


@dataclass
class FSMTensors(_Leaves):
    """Static per-scenario tables of the in-run FSM (host NumPy, or tensors
    after `to`); a fleet stacks them along a leading scenario axis."""

    # behavior frame per agent (HostFrame tables, padded to a common R)
    f_xy: object          # (A, R, 2)
    f_s: object           # (A, R)
    f_seg_valid: object   # (A, R-1), padded segments excluded

    # static route goals per agent (padded to G rows)
    g_valid: object       # (A, G)
    g_start: object       # (A, G)
    g_end: object         # (A, G)
    g_type: object        # (A, G) int32 codes
    g_has_stop: object    # (A, G)
    g_stop_s: object      # (A, G)
    g_stop_xy: object     # (A, G, 2)
    tl_code: object       # (C, A, G) int32, light state per cycle per goal

    # lanelets (scenario dict order)
    ll_rings: object      # (L, E, 2) polygon rings (padded with the last vertex)
    ll_valid: object      # (L,)
    ll_in_ref: object     # (A, L), lanelet among the agent's reference ids
    ll_speed: object      # (L,) speed limit, +inf if none
    chain_mat: object     # (L, L), chain_mat[c, l]: l in chain(c)
    ll_left_ok: object    # (L,) left neighbour legal for overtaking

    # recorded (non-agent) dynamic obstacles
    ob_pos: object        # (T+1, Ob, 2)
    ob_vel: object        # (T+1, Ob)
    ob_valid: object      # (T+1, Ob)
    ob_len: object        # (Ob,)
    ob_ped: object        # (Ob,) pedestrian flag
    ob_member: object     # (T+1, Ob, L) lanelet membership
    ob_sd: object         # (A, T+1, Ob, 2) s, d on each agent's frame

    # final-goal stop data per agent
    fin_has: object       # (A,) s-interval present
    fin_lo: object        # (A,)
    fin_hi: object        # (A,)
    fin_v_has: object     # (A,)
    fin_v: object         # (A,)
    fin_t_has: object     # (A,)
    fin_t_lo: object      # (A,)
    fin_t_hi: object      # (A,)

    speed_limit_default: object   # () street-setting default (constant)
    is_hc: object                 # () bool, Highway or Country


@dataclass
class FSMCarry(_Leaves):
    """The FSM state carried from cycle to cycle (per agent)."""

    sit: object           # (A,) int32 situation code
    goal_idx: object      # (A,) int32 current static-goal row (-1: none yet)
    prev_type: object     # (A,) int32 previous behavior_state_static code
    slowing: object       # (A,) bool slowing_car_for_traffic_light
    waiting: object       # (A,) bool waiting_for_green_light
    wait_counter: object  # (A,) int32
    hold_has: object      # (A,) bool, latched Waiting* hold
    hold_s: object        # (A,)
    stopdist_has: object  # (A,) bool, VP_state.stop_distance armed
    stopdist: object      # (A,)
    mode_final: object    # (A,) bool, stop_point_mode ends in 'final goal'
    dvsp_prev: object     # (A,) desired_velocity_stop_point of the last cycle
    dvsp_has: object      # (A,) bool (host: None until the first calculation)
    cur_ll: object        # (A,) int32 current-lanelet index (-1: unknown)
    bail: object          # () bool, an unsupported transition was wanted


def fsm_carry0(agents, scenario, dtype) -> FSMCarry:
    """The initial carry of fresh BehaviorModules: the current lanelet from
    the initial pose, everything else at its default."""
    a_n = len(agents)
    ll_index = {lid: i for i, lid in enumerate(scenario.lanelets)}
    cur = np.full(a_n, -1, np.int32)
    for i, a in enumerate(agents):
        if a.behavior is not None:
            cur[i] = ll_index.get(a.behavior.bm.current_lanelet_id, -1)
    z = np.zeros(a_n, dtype)
    f = np.zeros(a_n, bool)
    return FSMCarry(
        sit=np.zeros(a_n, np.int32), goal_idx=np.full(a_n, -1, np.int32),
        prev_type=np.zeros(a_n, np.int32), slowing=f.copy(), waiting=f.copy(),
        wait_counter=np.zeros(a_n, np.int32), hold_has=f.copy(), hold_s=z.copy(),
        stopdist_has=f.copy(), stopdist=z.copy(), mode_final=f.copy(),
        dvsp_prev=z.copy(), dvsp_has=f.copy(), cur_ll=cur,
        bail=np.zeros((), bool),
    )


def build_fsm_tensors(sim, dtype):
    """(FSMTensors, supported, reason) for one host Simulation whose agents
    carry BehaviorModules.  supported=False: the caller takes the hybrid
    path."""
    agents = sim.agents
    scenario = sim.scenario
    config = sim.config

    if any(a.behavior is None for a in agents):
        return None, False, "agent without behavior module"
    if config.occlusion.use_occlusion_module:
        return None, False, "occlusion module (hybrid only)"

    # ---- scope ------------------------------------------------------------
    settings = set()
    for a in agents:
        bm = a.behavior.bm
        if bm.nav_lane_changes_left or bm.nav_lane_changes_right:
            return None, False, "navigation lane changes"
        settings.add(bm.street_setting)
        for g in bm.PP_state.static_route_plan:
            if g.goal_type not in _TYPE_CODE:
                return None, False, f"goal type {g.goal_type}"
    if len(settings) != 1:
        return None, False, "mixed street settings"
    setting = settings.pop()
    # the host derives the setting from the CURRENT lanelet each step, and a
    # change would reset its FSM: every lanelet must map to the same setting
    tags = [t.lower() for t in getattr(scenario, "tags", [])]
    tag_setting = "Highway" if ("interstate" in tags or "highway" in tags) \
        else "Urban"
    for ll in scenario.lanelets.values():
        ltype = (getattr(ll, "lanelet_type", "") or "").lower()
        if any(t in ltype for t in ("highway", "interstate")):
            s = "Highway"
        elif "country" in ltype:
            s = "Country"
        elif "urban" in ltype:
            s = "Urban"
        else:
            s = tag_setting
        if s != setting:
            return None, False, "street setting varies across lanelets"

    a_n = len(agents)
    k = int(config.planning.replanning_frequency)
    n_cycles = (int(sim.max_steps) + k - 1) // k

    # ---- frames -----------------------------------------------------------
    frames = [a.behavior.bm.PP_state.frame for a in agents]
    r_max = max(len(fr.xy) for fr in frames)
    f_xy = np.zeros((a_n, r_max, 2))
    f_s = np.zeros((a_n, r_max))
    f_seg_valid = np.zeros((a_n, r_max - 1), bool)
    for i, fr in enumerate(frames):
        r = len(fr.xy)
        f_xy[i, :r] = fr.xy
        f_xy[i, r:] = fr.xy[-1]
        f_s[i, :r] = fr.s
        f_s[i, r:] = fr.s[-1]
        f_seg_valid[i, : r - 1] = True

    # ---- static route goals ----------------------------------------------
    g_rows = max(max(len(a.behavior.bm.PP_state.static_route_plan)
                     for a in agents), 1)
    g_valid = np.zeros((a_n, g_rows), bool)
    g_start = np.zeros((a_n, g_rows))
    g_end = np.zeros((a_n, g_rows))
    g_type = np.zeros((a_n, g_rows), np.int32)
    g_has_stop = np.zeros((a_n, g_rows), bool)
    g_stop_s = np.zeros((a_n, g_rows))
    g_stop_xy = np.zeros((a_n, g_rows, 2))
    tl_code = np.zeros((n_cycles, a_n, g_rows), np.int32)
    for i, a in enumerate(agents):
        for j, g in enumerate(a.behavior.bm.PP_state.static_route_plan):
            g_valid[i, j] = True
            g_start[i, j] = g.start_s
            g_end[i, j] = g.end_s
            g_type[i, j] = _TYPE_CODE[g.goal_type]
            if g.stop_point_s is not None:
                g_has_stop[i, j] = True
                g_stop_s[i, j] = g.stop_point_s
                g_stop_xy[i, j] = frames[i].to_cartesian(g.stop_point_s)
            if g.goal_object is not None and hasattr(g.goal_object,
                                                     "state_at_time"):
                for c in range(n_cycles):
                    st = g.goal_object.state_at_time(c * k)
                    tl_code[c, i, j] = (
                        TL_GREEN if st == "green"
                        else TL_REDYELLOW if st == "redYellow" else TL_OTHER)

    # ---- lanelets ---------------------------------------------------------
    ll_ids = list(scenario.lanelets)
    l_n = len(ll_ids)
    e_max = max(len(scenario.lanelets[lid].polygon) for lid in ll_ids)
    ll_rings = np.zeros((l_n, e_max, 2))
    ll_speed = np.full(l_n, np.inf)
    ll_left_ok = np.zeros(l_n, bool)
    for li, lid in enumerate(ll_ids):
        ll = scenario.lanelets[lid]
        ring = np.asarray(ll.polygon, float)
        ll_rings[li, : len(ring)] = ring
        ll_rings[li, len(ring):] = ring[-1]   # degenerate edges: no crossing
        v = speed_limit_for_lanelets(scenario, [lid])
        if v is not None:
            ll_speed[li] = v
        ll_left_ok[li] = (
            ll.adj_left is not None and ll.adj_left_same_direction
            and ll.line_marking_left not in _NO_CROSS)
    chain_mat = np.zeros((l_n, l_n), bool)
    ll_index = {lid: i for i, lid in enumerate(ll_ids)}
    for li, lid in enumerate(ll_ids):
        for cid in consecutive_lanelet_chain(scenario, lid):
            chain_mat[li, ll_index[cid]] = True
    ll_in_ref = np.zeros((a_n, l_n), bool)
    for i, a in enumerate(agents):
        for lid in a.behavior.bm.PP_state.reference_path_ids:
            if lid in ll_index:
                ll_in_ref[i, ll_index[lid]] = True

    # ---- recorded (non-agent) dynamic obstacles ---------------------------
    agent_ids = {a.id for a in agents}
    obs = [ob for oid, ob in scenario.obstacles.items()
           if oid not in agent_ids and ob.role == "dynamic"]
    t1 = int(sim.max_steps) + 1
    ob_n = max(len(obs), 1)
    ob_pos = np.zeros((t1, ob_n, 2))
    ob_vel = np.zeros((t1, ob_n))
    ob_valid = np.zeros((t1, ob_n), bool)
    ob_len = np.full(ob_n, 4.5)
    ob_ped = np.zeros(ob_n, bool)
    ob_member = np.zeros((t1, ob_n, l_n), bool)
    ob_sd = np.zeros((a_n, t1, ob_n, 2))
    for j, ob in enumerate(obs):
        ob_len[j] = ob.length
        ob_ped[j] = ob.obstacle_type == "pedestrian"
        for t in range(t1):
            st = ob.state_at_time(t)
            if st is None:
                continue
            ob_pos[t, j] = st.position
            ob_vel[t, j] = st.velocity
            ob_valid[t, j] = True
            for lid in scenario.find_lanelets_by_position(st.position):
                ob_member[t, j, ll_index[lid]] = True
            for i in range(a_n):
                s, d = frames[i].project(np.asarray(st.position))
                ob_sd[i, t, j] = (s, d)

    # ---- final-goal stop data ---------------------------------------------
    fin_has = np.zeros(a_n, bool)
    fin_lo = np.zeros(a_n)
    fin_hi = np.zeros(a_n)
    fin_v_has = np.zeros(a_n, bool)
    fin_v = np.zeros(a_n)
    fin_t_has = np.zeros(a_n, bool)
    fin_t_lo = np.zeros(a_n)
    fin_t_hi = np.zeros(a_n)
    for i, a in enumerate(agents):
        bm = a.behavior.bm
        iv = bm.PP_state.final_s_position_interval
        if iv is not None:
            fin_has[i] = True
            fin_lo[i], fin_hi[i] = iv
        if bm.VP_state.final_velocity_center is not None:
            fin_v_has[i] = True
            fin_v[i] = bm.VP_state.final_velocity_center
        g = (bm.planning_problem.goals[bm.goal_index]
             if bm.goal_index is not None else None)
        t_int = getattr(g, "time_interval", None) if g is not None else None
        if t_int is not None:
            fin_t_has[i] = True
            fin_t_lo[i], fin_t_hi[i] = t_int

    def c(x):
        x = np.asarray(x)
        return x.astype(dtype) if x.dtype.kind == "f" else x

    ft = FSMTensors(
        f_xy=c(f_xy), f_s=c(f_s), f_seg_valid=f_seg_valid,
        g_valid=g_valid, g_start=c(g_start), g_end=c(g_end), g_type=g_type,
        g_has_stop=g_has_stop, g_stop_s=c(g_stop_s), g_stop_xy=c(g_stop_xy),
        tl_code=tl_code,
        ll_rings=c(ll_rings), ll_valid=np.ones(l_n, bool),
        ll_in_ref=ll_in_ref, ll_speed=c(ll_speed),
        chain_mat=chain_mat, ll_left_ok=ll_left_ok,
        ob_pos=c(ob_pos), ob_vel=c(ob_vel), ob_valid=ob_valid,
        ob_len=c(ob_len), ob_ped=ob_ped, ob_member=ob_member,
        ob_sd=c(ob_sd),
        fin_has=fin_has, fin_lo=c(fin_lo), fin_hi=c(fin_hi),
        fin_v_has=fin_v_has, fin_v=c(fin_v),
        fin_t_has=fin_t_has, fin_t_lo=c(fin_t_lo), fin_t_hi=c(fin_t_hi),
        speed_limit_default=c(_DEFAULT_SPEED_LIMIT.get(setting, 30 / 3.6)),
        is_hc=np.asarray(setting in ("Highway", "Country")),
    )
    return ft, True, ""


# ---------------------------------------------------------------------------
# the step (torch; leading axes before the agent axis ride along)
# ---------------------------------------------------------------------------


def _gather_last(x, idx):
    """x (..., A, G) at idx (..., A) → (..., A)."""
    return torch.gather(x, -1, idx[..., None].long())[..., 0]


def _gather_rows(x, idx):
    """x (..., A, G, W) at idx (..., A) → (..., A, W)."""
    w = x.shape[-1]
    return torch.gather(
        x, -2, idx[..., None, None].long().expand(idx.shape + (1, w)))[..., 0, :]


def _project_all(f_xy, f_s, f_valid, pts):
    """`HostFrame.project` of every point on every agent's frame:
    frames (..., A, R, 2), points (..., P, 2) → s, d (..., A, P)."""
    a = f_xy[..., :-1, :]                                    # (..., A, R-1, 2)
    ab = f_xy[..., 1:, :] - a
    seg2 = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)   # (..., A, R-1)
    ap = pts[..., None, :, None, :] - a[..., :, None, :, :]     # (..., A, P, R-1, 2)
    t = torch.clamp(torch.sum(ap * ab[..., :, None, :, :], dim=-1)
                    / seg2[..., :, None, :], 0.0, 1.0)
    closest = a[..., :, None, :, :] + t[..., None] * ab[..., :, None, :, :]
    d2 = torch.sum((pts[..., None, :, None, :] - closest) ** 2, dim=-1)
    d2 = torch.where(f_valid[..., :, None, :], d2, torch.full_like(d2, torch.inf))
    i = torch.argmin(d2, dim=-1)                             # (..., A, P)

    def pick(x):                                             # x (..., A, P, R-1)
        return torch.gather(x, -1, i[..., None])[..., 0]

    t_i = pick(t)
    s_lo = torch.gather(f_s, -1, i)                          # f_s (..., A, R)
    s_hi = torch.gather(f_s, -1, i + 1)
    s = s_lo + t_i * (s_hi - s_lo)
    ab_i = torch.stack([torch.gather(ab[..., k], -1, i) for k in (0, 1)], dim=-1)
    a_i = torch.stack([torch.gather(a[..., k], -1, i) for k in (0, 1)], dim=-1)
    ap_i = pts[..., None, :, :] - a_i
    crossz = ab_i[..., 0] * ap_i[..., 1] - ab_i[..., 1] * ap_i[..., 0]
    sign = torch.where(crossz >= 0.0, torch.ones_like(crossz), -torch.ones_like(crossz))
    d = torch.sqrt(pick(d2)) * sign
    return s, d


def _point_in_lanelets(rings, valid, pts):
    """(..., P, 2) → (..., P, L) even-odd membership (`io.commonroad.
    _point_in_ring`); padded ring vertices repeat the last point, so their
    degenerate edges add no crossings."""
    a = rings[..., None, :, :, :]                            # (..., 1, L, E, 2)
    b = torch.roll(rings, -1, dims=-2)[..., None, :, :, :]
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    px = pts[..., :, None, None, 0]
    py = pts[..., :, None, None, 1]
    cond = (ay > py) != (by > py)
    denom = by - ay
    x_int = ax + (py - ay) * (bx - ax) / torch.where(denom == 0.0,
                                                       torch.ones_like(denom), denom)
    hits = cond & (px < x_int)
    inside = (torch.sum(hits, dim=-1) % 2).bool()            # (..., P, L)
    return inside & valid[..., None, :]


def _stop_dist(v, decel):
    return torch.abs(v ** 2 / (-2.0 * decel))


def make_fsm_step(config, veh, dt, k_replan):
    """The in-run FSM step:

        fsm_step(ft, carry, c, t0, center, theta, v, running, peer_present)
            → (carry', v_des, stop_s_planner, stop_v)

    `c` and `t0` are one-element int64 tensors (cycle and global step),
    `center` (..., A, 2), `theta`, `v`, `running`, `peer_present` (..., A);
    `ft` and `carry` are FSMTensors / FSMCarry of tensors with the same
    leading axes.  The order is that of `BehaviorModule.execute` for the
    supported scope: project → lanelet information → preceding vehicle →
    static layer of the FSM → overtake detection (bail) → velocity planner →
    stop point → braking envelope.  `peer_present[j]`: agent j has a state
    at t0 (the WorldView rule)."""
    cfg = config.behavior
    # the planner constants, as in the host modules
    decel = cfg.comfortable_deceleration_rate
    buf = cfg.safety_distance_buffer
    d_amx = cfg.a_max_delta
    a_max, v_max = veh.a_max, veh.v_max
    length = veh.length
    min_wait_steps = int(1.0 / dt)

    def fsm_step(ft: FSMTensors, carry: FSMCarry, c, t0, center, theta, v,
                 running, peer_present):
        dtype = center.dtype
        nl = center.dim() - 2                       # leading axes before A
        a_n = center.shape[-2]
        t0f = t0.to(dtype)
        big = torch.full_like(v, float(np.finfo(np.float32).max / 4))
        eye = torch.eye(a_n, dtype=torch.bool, device=center.device)

        def at(x, index, axis=nl):
            """x at cycle or step `index` (1,) along `axis`."""
            return torch.index_select(x, axis, index).squeeze(axis)

        def full(value, like=v):
            return torch.full_like(like, value)

        # 1. every agent's center on every agent's frame
        peer_s, peer_d = _project_all(ft.f_xy, ft.f_s, ft.f_seg_valid, center)
        ref_s = torch.diagonal(peer_s, dim1=-2, dim2=-1)   # (..., A)

        # 2. current lanelet + speed limit
        member = _point_in_lanelets(ft.ll_rings, ft.ll_valid, center)  # (..., A, L)
        l_n = member.shape[-1]
        n_member = torch.sum(member, dim=-1)
        order = torch.arange(l_n, device=center.device)
        first_m = torch.argmax(member.to(torch.int32), dim=-1)
        in_ref = member & ft.ll_in_ref
        last_ref = l_n - 1 - torch.argmax(torch.flip(in_ref, dims=(-1,)).to(torch.int32),
                                          dim=-1)
        has_ref = torch.any(in_ref, dim=-1)
        cur = torch.where(
            n_member == 1, first_m,
            torch.where(n_member > 1, torch.where(has_ref, last_ref, first_m),
                        carry.cur_ll.long()))
        mem_or_cur = torch.where(
            (n_member > 0)[..., None], member,
            (order == cur[..., None]) & (cur[..., None] >= 0))
        sl = torch.amin(torch.where(mem_or_cur, ft.ll_speed[..., None, :],
                                    torch.full_like(ft.ll_speed[..., None, :],
                                                    torch.inf)), dim=-1)
        limit = torch.where(torch.isfinite(sl), sl,
                            ft.speed_limit_default[..., None].expand_as(sl))

        # 3. preceding vehicle
        cur_c = torch.clamp(cur, min=0)
        chain = torch.gather(ft.chain_mat, -2,
                             cur_c[..., None].expand(cur_c.shape + (l_n,)))
        chain = chain & (cur >= 0)[..., None]                       # (..., A, L)
        ob_m = at(ft.ob_member, t0)                                 # (..., Ob, L)
        ob_on_chain = torch.any(chain[..., :, None, :] & ob_m[..., None, :, :],
                                dim=-1)                             # (..., A, Ob)
        ob_sd = at(ft.ob_sd, t0, nl + 1)                            # (..., A, Ob, 2)
        ob_s, ob_d = ob_sd[..., 0], ob_sd[..., 1]
        ob_valid_t = at(ft.ob_valid, t0)                            # (..., Ob)
        ob_pos_t = at(ft.ob_pos, t0)                                # (..., Ob, 2)
        ob_vel_t = at(ft.ob_vel, t0)
        ob_ok = (ob_on_chain & ob_valid_t[..., None, :]
                 & (ob_s > ref_s[..., None]) & (torch.abs(ob_d) <= 4.0))
        peer_on_chain = torch.any(chain[..., :, None, :] & member[..., None, :, :],
                                  dim=-1)                           # (..., A, A)
        peer_ok = (peer_present[..., None, :] & ~eye & peer_on_chain
                   & (peer_s > ref_s[..., None]) & (torch.abs(peer_d) <= 4.0))
        big_ob = big[..., None].expand_as(ob_s)
        big_pe = big[..., None].expand_as(peer_s)
        all_s = torch.cat([torch.where(ob_ok, ob_s, big_ob),
                           torch.where(peer_ok, peer_s, big_pe)], dim=-1)
        lead = torch.argmin(all_s, dim=-1)     # the first minimum: world order
        has_lead = _gather_last(torch.cat([ob_ok, peer_ok], dim=-1), lead)
        ob_n = ob_s.shape[-1]
        lead_is_ob = lead < ob_n
        ob_i = torch.clamp(lead, 0, ob_n - 1)
        pe_i = torch.clamp(lead - ob_n, 0, a_n - 1)
        lead_pos = torch.where(
            lead_is_ob[..., None],
            torch.stack([torch.gather(ob_pos_t[..., k], -1, ob_i) for k in (0, 1)],
                        dim=-1),
            torch.stack([torch.gather(center[..., k], -1, pe_i) for k in (0, 1)],
                        dim=-1))
        lead_vel = torch.where(lead_is_ob, torch.gather(ob_vel_t, -1, ob_i),
                               torch.gather(v, -1, pe_i))
        lead_len = torch.where(lead_is_ob, torch.gather(
            ft.ob_len.expand(ob_vel_t.shape), -1, ob_i), full(length))
        dist_prec = torch.linalg.norm(lead_pos - center, dim=-1) - lead_len / 2.0

        # 4. static layer: goal select + reset on a change of goal type
        in_range = (ft.g_valid & (ft.g_start <= ref_s[..., None])
                    & (ref_s[..., None] < ft.g_end))
        any_goal = torch.any(in_range, dim=-1)
        goal_idx = torch.where(any_goal, torch.argmax(in_range.to(torch.int32), dim=-1),
                               carry.goal_idx.long())
        has_goal = goal_idx >= 0
        gi = torch.clamp(goal_idx, min=0)
        gtype = torch.where(has_goal, _gather_last(ft.g_type, gi).long(),
                            torch.zeros_like(gi))
        stopline = gtype != T_DEFAULT
        main_sign = (gtype == T_TL) | (gtype == T_STOP) | (gtype == T_YIELD) \
            | (gtype == T_CROSS)
        full_stop = (gtype == T_STOP_PREP) | (gtype == T_STOP)
        ped_only = (gtype == T_CROSS_PREP) | (gtype == T_CROSS)

        sit0 = carry.sit.long()
        changed = gtype != carry.prev_type.long()
        sit = torch.where(changed, torch.zeros_like(sit0), sit0)
        wait_counter = torch.where(changed, torch.zeros_like(sit0),
                                   carry.wait_counter.long())
        leaving_stopline = changed & ~stopline
        slowing = carry.slowing & ~leaving_stopline
        waiting = carry.waiting & ~leaving_stopline
        stopdist_has = carry.stopdist_has & ~leaving_stopline
        stopdist = carry.stopdist

        g_has_stop = has_goal & _gather_last(ft.g_has_stop, gi)
        g_stop_s = _gather_last(ft.g_stop_s, gi)
        g_stop_xy = _gather_rows(ft.g_stop_xy, gi)               # (..., A, 2)

        # 5. situation transitions.  Stop-line clearance
        # (fsm._stop_point_clear): a moving foreign obstacle within 12 m of
        # the stop point blocks
        obs_block = (
            (torch.linalg.norm(ob_pos_t[..., None, :, :] - g_stop_xy[..., :, None, :],
                               dim=-1) < 12.0)
            & ob_valid_t[..., None, :] & (ob_vel_t[..., None, :] > 0.3))
        p_block = (
            (torch.linalg.norm(center[..., None, :, :] - g_stop_xy[..., :, None, :],
                               dim=-1) < 12.0)
            & peer_present[..., None, :] & ~eye & (v[..., None, :] > 0.3))
        blocked_any = torch.any(obs_block, dim=-1) | torch.any(p_block, dim=-1)
        blocked_ped = torch.any(obs_block & ft.ob_ped[..., None, :], dim=-1)
        clear = ~g_has_stop | ~torch.where(ped_only, blocked_ped, blocked_any)

        tl = _gather_last(at(ft.tl_code, c), gi)
        tl_green = tl == TL_GREEN
        tl_go = (tl == TL_GREEN) | (tl == TL_REDYELLOW)

        is_tl_prep = gtype == T_TL_PREP
        is_tl = gtype == T_TL
        is_sign_prep = (gtype == T_STOP_PREP) | (gtype == T_YIELD_PREP) \
            | (gtype == T_CROSS_PREP)
        is_sign = (gtype == T_STOP) | (gtype == T_YIELD) | (gtype == T_CROSS)

        def code(value):
            return torch.full_like(sit, value)

        # PrepareTrafficLight (fsm._situation_prepare_light): the host's
        # if/elif chain branches on the state after the init step
        st1 = torch.where(sit == S_NONE, code(S_OBSERVE), sit)
        e_o1 = st1 == S_OBSERVE
        e_s1 = st1 == S_SLOWING
        st1 = torch.where(e_o1 & ~tl_green, code(S_SLOWING), st1)
        st1 = torch.where(e_s1 & tl_go, code(S_OBSERVE), st1)
        arm1 = st1 == S_SLOWING

        # TrafficLight (fsm._situation_light)
        st2 = torch.where(sit == S_NONE,
                          torch.where(tl_green, code(S_GREEN), code(S_STOPPING)), sit)
        e_g = st2 == S_GREEN
        e_s2 = st2 == S_STOPPING
        e_w2 = st2 == S_WAITING
        st2 = torch.where(e_g & ~tl_green, code(S_STOPPING), st2)
        st2 = torch.where(e_s2 & tl_go, code(S_GREEN), st2)
        to_w2 = e_s2 & ~tl_go & (v <= 0.5)
        st2 = torch.where(to_w2, code(S_WAITING), st2)
        st2 = torch.where(e_w2 & tl_go, code(S_CONTINUE), st2)
        arm2 = (st2 == S_STOPPING) | (st2 == S_WAITING)
        waiting2 = to_w2 | (waiting & ~((e_w2 & tl_go) | (st2 == S_CONTINUE)))

        # sign prepare (fsm._make_sign_situation, prepare)
        st3 = torch.where(sit == S_NONE, code(S_OBSERVE), sit)
        e_o3 = st3 == S_OBSERVE
        e_s3 = st3 == S_SLOWING
        st3 = torch.where(e_o3 & ~clear, code(S_SLOWING), st3)
        st3 = torch.where(e_s3 & clear, code(S_OBSERVE), st3)
        arm3 = st3 == S_SLOWING

        # sign main (fsm._make_sign_situation, main): arms on branch ENTRY
        # (Stopping / Waiting), not on the final state
        st4 = torch.where(sit == S_NONE,
                          torch.where(full_stop | ~clear, code(S_STOPPING),
                                      code(S_CLEAR)), sit)
        e_c4 = st4 == S_CLEAR
        e_s4 = st4 == S_STOPPING
        e_w4 = st4 == S_WAITING
        st4 = torch.where(e_c4 & ~clear, code(S_STOPPING), st4)
        to_w4 = e_s4 & (v <= 0.5)
        st4 = torch.where(to_w4, code(S_WAITING), st4)
        wc4 = torch.where(to_w4, torch.zeros_like(wait_counter), wait_counter)
        st4 = torch.where(e_s4 & ~to_w4 & clear & ~full_stop, code(S_CLEAR), st4)
        wc4 = torch.where(e_w4, wc4 + 1, wc4)
        min_wait = full_stop.long() * min_wait_steps
        st4 = torch.where(e_w4 & clear & (wc4 >= min_wait), code(S_CONTINUE), st4)
        arm4 = e_s4 | e_w4
        slow4 = arm4 & ~(st4 == S_CONTINUE)

        # merge the families
        sit_new = torch.where(
            is_tl_prep, st1,
            torch.where(is_tl, st2,
                        torch.where(is_sign_prep, st3,
                                    torch.where(is_sign, st4, code(S_NONE)))))
        arm = torch.where(
            is_tl_prep, arm1,
            torch.where(is_tl, arm2, torch.where(is_sign_prep, arm3, is_sign & arm4)))
        slowing = torch.where(
            is_tl_prep, arm1,
            torch.where(is_tl, arm2,
                        torch.where(is_sign_prep, arm3,
                                    torch.where(is_sign, slow4, slowing))))
        waiting = torch.where(is_tl, waiting2,
                              waiting & ~(is_sign & (st4 == S_CONTINUE)))
        wait_counter = torch.where(is_sign, wc4, wait_counter)

        # _arm_stop side effects (stop-line distance and queueing)
        dist_to_tl = g_stop_s - ref_s - length
        queue_dist = dist_prec - length - lead_len
        armed_sd = torch.where(has_lead & (queue_dist <= dist_to_tl),
                               queue_dist, dist_to_tl)
        fire = arm & g_has_stop
        stopdist = torch.where(fire, armed_sd, stopdist)
        stopdist_has = stopdist_has | fire

        # 6. dynamic layer: the wish to overtake → bail
        no_auto = ft.is_hc[..., None] & (gtype != T_DEFAULT)
        left_ok = _gather_last(ft.ll_left_ok[..., None, :].expand(member.shape), cur_c) & (cur >= 0)
        wants_ot = (running & (t0 > 0) & ~no_auto & has_lead & left_ok
                    & (lead_vel < 0.6 * limit)
                    & (dist_prec < torch.clamp(3.0 * v, min=25.0)))
        bail = carry.bail | torch.any(wants_ot, dim=-1)

        # 7. velocity planner
        comfort_dist = v * dt * k_replan + _stop_dist(v, decel)
        vmax_ = limit                              # condition factor 1.0
        delta = dt * k_replan
        ego_stop = _stop_dist(v, a_max)
        other_stop = _stop_dist(lead_vel, a_max)
        base_safe = length / 2 + 0.5
        # the four relative-motion situations, paired with the sign of the
        # distance as the host does (velocity_planner.py)
        dpos = dist_prec >= 0.0
        towards = torch.where(dpos, (v >= 0) & (lead_vel < 0),
                              (v < 0) & (lead_vel >= 0))
        ego_behind = torch.where(dpos, (v >= 0) & (lead_vel >= 0),
                                 (v < 0) & (lead_vel < 0))
        ego_front = torch.where(dpos, (v < 0) & (lead_vel < 0),
                                (v >= 0) & (lead_vel >= 0))
        min_safety = torch.where(
            towards,
            base_safe + torch.abs(v * delta) + ego_stop + other_stop,
            torch.where(
                ego_behind,
                base_safe + torch.abs(v * delta) + ego_stop - other_stop,
                torch.where(
                    ego_front,
                    base_safe + torch.abs(lead_vel * delta) + other_stop - ego_stop,
                    full(base_safe - np.inf))))
        safety = torch.where(
            towards,
            min_safety + torch.maximum(v * buf, lead_vel * buf),
            min_safety + (lead_vel + v) / 2 * buf)
        ttc = lead_vel + (dist_prec - safety) / cfg.ttc_norm
        has_ttc = has_lead

        goal_v = torch.where(has_ttc & (ttc < vmax_), ttc, vmax_)
        override = carry.mode_final & (
            ~has_ttc | (carry.dvsp_has & (carry.dvsp_prev < ttc)))
        goal_v = torch.where(override, carry.dvsp_prev, goal_v)

        lo1 = torch.where(v > 0, v - 2 * a_max * d_amx, v - a_max * d_amx)
        lo2 = torch.where(v >= 0.0, torch.zeros_like(v), v + a_max * d_amx)
        hi1 = torch.where(v >= 0, v + a_max * d_amx, v + 2 * a_max * d_amx)
        hi2 = torch.where(v_max >= v, full(v_max), v - 2 * a_max * d_amx)
        v_des = torch.minimum(torch.minimum(
            torch.maximum(torch.maximum(goal_v, lo1), lo2), hi1), hi2)
        v_des = torch.where(v_des <= cfg.zero_velocity_threshold,
                            torch.zeros_like(v_des), v_des)

        # 8. stop point (behavior_module._calculate_stopping_point)
        comfort_s = ref_s + comfort_dist
        min_dist = torch.clamp(cfg.min_stop_point_time * v, min=cfg.min_stop_point_dist)
        default_time_s = ref_s + v * cfg.default_time_horizon
        armed_goal = stopline & g_has_stop

        obs_sit = sit_new == S_OBSERVE
        slow_sit = sit_new == S_SLOWING
        go_sit = (sit_new == S_GREEN) | (sit_new == S_CLEAR)
        stop_sit = sit_new == S_STOPPING
        wait_sit = sit_new == S_WAITING

        sp_armed = torch.where(
            obs_sit | slow_sit | stop_sit,
            torch.minimum(g_stop_s, comfort_s),
            torch.where(go_sit,
                        torch.maximum(torch.maximum(g_stop_s, comfort_s),
                                      default_time_s),
                        torch.maximum(comfort_s, default_time_s)))
        dv_armed = torch.where(slow_sit | stop_sit, torch.zeros_like(goal_v), goal_v)
        sp = torch.where(armed_goal, sp_armed, torch.maximum(comfort_s, default_time_s))
        dvsp = torch.where(armed_goal, dv_armed, goal_v)

        # the Waiting hold (an early return of the host; the latch is
        # released by any armed step that is not waiting)
        waiting_early = armed_goal & wait_sit
        latch = waiting_early & ~carry.hold_has
        hold_s = torch.where(latch, ref_s, carry.hold_s)
        hold_has = (carry.hold_has | latch) & ~(armed_goal & ~wait_sit)

        # TTC stop point (the standing-obstacle branch is an early return)
        ttc_stop_s = ref_s + dist_prec + other_stop - min_safety
        standing = has_ttc & (lead_vel < cfg.standing_obstacle_vel)
        use_ttc = has_ttc & ~standing
        ttc_lt = main_sign & stop_sit & armed_goal & (ttc_stop_s < g_stop_s)
        sp = torch.where(use_ttc, torch.minimum(ttc_stop_s, comfort_s), sp)
        dvsp = torch.where(use_ttc,
                           torch.where(ttc_lt, torch.minimum(lead_vel, v), lead_vel),
                           dvsp)

        # nose offset and clamps (skipped by the early returns)
        sp2 = sp - length / 2
        sp2 = torch.clamp(torch.maximum(ref_s + min_dist, sp2), min=0.0)
        sp2 = torch.where((slow_sit | stop_sit) & armed_goal,
                          torch.minimum(sp2, g_stop_s - length / 2), sp2)

        # final-goal stop (behavior_module._final_goal_stop)
        final_s_val = torch.maximum(ft.fin_hi - length / 2, ft.fin_lo)
        decel_dist = _stop_dist(v, decel) - _stop_dist(ft.fin_v, decel)
        in_iv = (ft.fin_lo <= ref_s) & (ref_s <= ft.fin_hi)
        v_adapt_iv = torch.where(in_iv, ref_s,
                                 torch.maximum(ft.fin_lo - decel_dist, ref_s))
        in_t = ft.fin_t_has & (ft.fin_t_lo <= t0f) & (t0f <= ft.fin_t_hi)
        avg_v = (v + ft.fin_v) / 2
        decel_time = decel_dist / torch.clamp(avg_v, min=1e-6)
        v_adapt_t = ref_s + torch.clamp(ft.fin_t_lo - decel_time - t0f, min=0.0) * v
        v_adapt = torch.where(ft.fin_has, v_adapt_iv,
                              torch.where(in_t, ref_s, v_adapt_t))
        has_adapt = ft.fin_v_has & (ft.fin_has | ft.fin_t_has)
        sp2 = torch.where(ft.fin_has, torch.minimum(final_s_val, sp2), sp2)
        approx_next = ref_s + v * dt * k_replan
        adapt_now = has_adapt & (v_adapt <= approx_next)
        dvsp = torch.where(adapt_now, ft.fin_v, dvsp)

        # merge the early-return branches
        standing_sp = torch.minimum(comfort_s, ref_s + dist_prec - length / 2 - 0.5)
        sp_final = torch.where(waiting_early, hold_s,
                               torch.where(standing, standing_sp, sp2))
        dvsp_final = torch.where(waiting_early | standing, torch.zeros_like(dvsp), dvsp)
        mode_final_new = (~waiting_early & ~standing & (dvsp_final != 0.0)
                          & ft.fin_v_has & (dvsp_final == ft.fin_v))

        # 9. braking envelope toward the armed stop line
        v_env = torch.sqrt(2.0 * decel * torch.clamp(stopdist, min=0.0))
        v_des = torch.where(slowing & stopdist_has & (v_env < v_des), v_env, v_des)

        # 10. the planner's stop point (apply_behavior_output: center → rear
        # axle)
        stop_s_planner = sp_final - veh.wb_rear_axle

        # frozen agents keep every carried field (the host does not run
        # their FSM again) and hand back their current velocity
        def keep(new, old):
            return torch.where(running, new.to(old.dtype), old)

        carry_new = FSMCarry(
            sit=keep(sit_new, carry.sit), goal_idx=keep(goal_idx, carry.goal_idx),
            prev_type=keep(gtype, carry.prev_type),
            slowing=keep(slowing, carry.slowing), waiting=keep(waiting, carry.waiting),
            wait_counter=keep(wait_counter, carry.wait_counter),
            hold_has=keep(hold_has, carry.hold_has), hold_s=keep(hold_s, carry.hold_s),
            stopdist_has=keep(stopdist_has, carry.stopdist_has),
            stopdist=keep(stopdist, carry.stopdist),
            mode_final=keep(mode_final_new, carry.mode_final),
            dvsp_prev=keep(dvsp_final, carry.dvsp_prev),
            dvsp_has=carry.dvsp_has | running,
            cur_ll=keep(cur, carry.cur_ll),
            bail=bail,
        )
        v_des = torch.where(running, v_des, v)
        return carry_new, v_des, stop_s_planner, dvsp_final

    return fsm_step


def pad_fsm_tensors(ft: FSMTensors, carry0: FSMCarry, a_max, r_max, g_max,
                    l_max, e_max, ob_max, t1_max, c_max):
    """One member's FSM tables padded to a fleet's maxima.

    The padding is inert: extra agents repeat agent 0 (frozen by
    active0 = False in the run), extra goal, lanelet and obstacle rows carry
    valid = False, extra cycles repeat the last light state, extra frame
    vertices repeat the last point with seg_valid = False."""
    def pad_a(x, axis=0):
        x = np.asarray(x)
        kk = a_max - x.shape[axis]
        if kk <= 0:
            return x
        rep = np.repeat(np.take(x, [0], axis=axis), kk, axis=axis)
        return np.concatenate([x, rep], axis=axis)

    def pad_full(x, size, axis, value=0):
        x = np.asarray(x)
        kk = size - x.shape[axis]
        if kk <= 0:
            return x
        shape = list(x.shape)
        shape[axis] = kk
        return np.concatenate([x, np.full(shape, value, x.dtype)], axis=axis)

    def pad_repeat(x, size, axis):
        x = np.asarray(x)
        kk = size - x.shape[axis]
        if kk <= 0:
            return x
        rep = np.repeat(np.take(x, [x.shape[axis] - 1], axis=axis), kk, axis=axis)
        return np.concatenate([x, rep], axis=axis)

    ft2 = FSMTensors(
        f_xy=pad_a(pad_repeat(ft.f_xy, r_max, 1)),
        f_s=pad_a(pad_repeat(ft.f_s, r_max, 1)),
        f_seg_valid=pad_a(pad_full(ft.f_seg_valid, r_max - 1, 1)),
        g_valid=pad_a(pad_full(ft.g_valid, g_max, 1)),
        g_start=pad_a(pad_full(ft.g_start, g_max, 1)),
        g_end=pad_a(pad_full(ft.g_end, g_max, 1)),
        g_type=pad_a(pad_full(ft.g_type, g_max, 1)),
        g_has_stop=pad_a(pad_full(ft.g_has_stop, g_max, 1)),
        g_stop_s=pad_a(pad_full(ft.g_stop_s, g_max, 1)),
        g_stop_xy=pad_a(pad_full(ft.g_stop_xy, g_max, 1)),
        tl_code=pad_full(pad_a(pad_repeat(ft.tl_code, c_max, 0), axis=1), g_max, 2),
        ll_rings=pad_full(pad_repeat(ft.ll_rings, e_max, 1), l_max, 0),
        ll_valid=pad_full(ft.ll_valid, l_max, 0),
        ll_in_ref=pad_a(pad_full(ft.ll_in_ref, l_max, 1)),
        ll_speed=pad_full(ft.ll_speed, l_max, 0, np.inf),
        chain_mat=pad_full(pad_full(ft.chain_mat, l_max, 0), l_max, 1),
        ll_left_ok=pad_full(ft.ll_left_ok, l_max, 0),
        ob_pos=pad_full(pad_full(ft.ob_pos, t1_max, 0), ob_max, 1),
        ob_vel=pad_full(pad_full(ft.ob_vel, t1_max, 0), ob_max, 1),
        ob_valid=pad_full(pad_full(ft.ob_valid, t1_max, 0), ob_max, 1),
        ob_len=pad_full(ft.ob_len, ob_max, 0, 4.5),
        ob_ped=pad_full(ft.ob_ped, ob_max, 0),
        ob_member=pad_full(pad_full(pad_full(
            ft.ob_member, t1_max, 0), ob_max, 1), l_max, 2),
        ob_sd=pad_a(pad_full(pad_full(ft.ob_sd, t1_max, 1), ob_max, 2)),
        fin_has=pad_a(ft.fin_has), fin_lo=pad_a(ft.fin_lo),
        fin_hi=pad_a(ft.fin_hi),
        fin_v_has=pad_a(ft.fin_v_has), fin_v=pad_a(ft.fin_v),
        fin_t_has=pad_a(ft.fin_t_has), fin_t_lo=pad_a(ft.fin_t_lo),
        fin_t_hi=pad_a(ft.fin_t_hi),
        speed_limit_default=np.asarray(ft.speed_limit_default),
        is_hc=np.asarray(ft.is_hc),
    )
    c2 = carry0.map(lambda leaf: pad_a(leaf) if np.asarray(leaf).ndim > 0
                    else np.asarray(leaf))
    return ft2, c2
