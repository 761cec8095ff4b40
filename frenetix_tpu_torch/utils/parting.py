"""Where two float32 runs part, and what decided it.

Two runs of the same scenario in float32 (the port on the card and on the
CPU, or the port and the JAX package) round differently, so their executed
states differ by a few ulps from the first step.  Such runs part for real
only at a cycle whose selection differs.  `CycleTrace` records every
`evaluate_cycle` call of a host planner module, `first_parting` finds the
first cycle whose selection differs, and `classify_parting` names what
decided it.  `RunTrace`, `first_run_parting` and `classify_run_parting` do
the same for the device-resident run (`parallel.device_sim`), against
another device run or a host run of one agent.  Two causes are accepted as
float32 rounding, not as a fault:

- "tie": every candidate is selectable on both sides and the two selected
  candidates' costs lie within `ULPS` float32 ulps of each other;
- "threshold": a selected candidate is selectable on one side only, and the
  only masks that differ are the velocity-sign tests (slots 2/10 `s_vel <
  -1e-5`, 4 `v < -1e-5`, 6 the yaw rate bound `kappa_max * v`, and the total
  in slot 0) of a stopping-mode candidate whose exact end velocity is 0: its
  float64 re-evaluation from the same sampling row lies within `ON_TARGET`
  of 0, so the test `s_vel < -1e-5` compares a value that float32 cannot
  resolve from its threshold.  The value that was flagged must lie within
  `ROUNDING_UNITS` float32 rounding units of the polynomial's terms
  (u * sum |i a_i t^(i-1)|, u = 2^-24) of 0.

Anything else at the parting cycle is returned as "unexplained" and the
caller treats it as a fault.

The FSM's outputs at the parting cycle are recorded and compared too: its
static behavior state must be equal, the desired velocity and the stop
point that the planner consumed must agree to `FSM_RTOL`, or the parting is
"unexplained".

The host tracer patches the `evaluate_cycle` name of a planner module, the
`plan` method of its `ReactivePlanner` and, where given, the `execute`
method of a behavior module's `BehaviorModule`; it works on any modules
with the port's interface and records numpy arrays only.

The run tracer patches the device run module's `evaluate_cycle`,
`select_with_fallback` and `_merge` names and its runner's `step`, and wraps
the run's FSM step (`behavior.device_fsm.make_fsm_step`) while a cycle runs.
The run evaluates every program every cycle (each sampling level and, with
the behavior planner, the stopping matrix, each in both kinematics modes)
and merges them per agent with `where`; the tracer follows which program's
output each agent's selection came from, and views a device cycle as the
host's sequence of tries: the stopping matrix first where the agent wants
it, then the levels up to the first that found a candidate, each in the
kinematics mode the agent took.  The device's stopping matrix keeps the
duplicate of the current d that the host's `union1d` drops, so candidates
are matched across a device and a host trace by their sampling row (t1, end
position or velocity, d1 within `MATCH_ULPS` float32 ulps), not by index.
It traces eager runs only (`run(graph=False)`): it copies to the host at
every call, which a CUDA graph cannot capture.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from frenetix_tpu_torch.behavior.device_fsm import _TYPE_CODE
from frenetix_tpu_torch.ops import polynomials as poly

__all__ = ["CycleTrace", "Parting", "RunTrace", "classify_parting",
           "classify_run_parting", "first_parting", "first_run_parting",
           "stopping_flips"]

ULPS = 4
ON_TARGET = 1e-9          # m/s: the float64 end velocity of a stopping row
ROUNDING_UNITS = 32       # float32 rounding units of the velocity polynomial
FSM_RTOL = 1e-4
VELOCITY_SIGN_SLOTS = frozenset({0, 2, 4, 6, 10})
_U32 = 2.0 ** -24
_EPS = 1e-5               # ops.kinematics._EPS: the negative-velocity test
MATCH_ULPS = 32           # float32 ulps: one sampling row on both sides
_MATCH_COLS = (1, 5, 10)  # t1, end velocity (end position when stopping), d1
_RUNNING = 1              # sim.agent.AgentStatus.RUNNING
_TYPE_NAME = {code: name for name, code in _TYPE_CODE.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class CycleTrace:
    """Context manager recording every `evaluate_cycle` call of the planner
    module `reactive` (one entry per sampling level, in call order), the
    FSM outputs each `plan` call consumed and, with `behavior` (a module
    holding `BehaviorModule`), the FSM's static state at that call."""

    reactive: object
    behavior: object = None
    levels: list = field(default_factory=list)
    plans: list = field(default_factory=list)

    def __enter__(self):
        mod, levels, plans = self.reactive, self.levels, self.plans
        self._evaluate, self._plan = mod.evaluate_cycle, mod.ReactivePlanner.plan
        evaluate, plan = self._evaluate, self._plan
        fsm = {"state": None}
        if self.behavior is not None:
            self._execute = execute = self.behavior.BehaviorModule.execute

            def traced_execute(module, predictions, ego_state, time_step):
                out = execute(module, predictions, ego_state, time_step)
                fsm["state"] = out.behavior_planner_state.get("behavior_state_static")
                return out

            self.behavior.BehaviorModule.execute = traced_execute

        def traced_evaluate(matrix, mask, ctx, **kw):
            res = evaluate(matrix, mask, ctx, **kw)
            ro = res.rollout
            levels.append({
                "plan": len(plans) - 1,
                "matrix": _np(matrix).astype(np.float64),
                "mask": _np(mask).astype(bool),
                "quintic": bool(kw.get("quintic_lon", False)),
                "best": int(_np(res.best_idx)),
                "found": bool(_np(res.found)),
                "selectable": _np(res.selectable).astype(bool),
                "cost": _np(res.cost).astype(np.float64),
                "slots": _np(ro.inf_slots).astype(bool),
                "s_vel_min": _np(ro.s_vel).min(axis=-1).astype(np.float64),
            })
            return res

        def traced_plan(planner, x0, x_cl):
            plans.append({"desired_velocity": float(planner.desired_velocity),
                          "stop_point": planner.stop_point,
                          "fsm_state": fsm["state"]})
            return plan(planner, x0, x_cl)

        mod.evaluate_cycle = traced_evaluate
        mod.ReactivePlanner.plan = traced_plan
        return self

    def __exit__(self, *exc):
        self.reactive.evaluate_cycle = self._evaluate
        self.reactive.ReactivePlanner.plan = self._plan
        if self.behavior is not None:
            self.behavior.BehaviorModule.execute = self._execute
        return False


@dataclass
class RunTrace:
    """Context manager recording every cycle of the eager device-resident
    runs of the module `run_module` (`parallel.device_sim`) of one scenario
    (no fleet, no mesh).  `cycles` gets one entry per cycle:

    - "cycle", "agent_ids", "live" (A,): the agent ran that cycle (a RUNNING
      status at one of its sub-steps, as `tools/tie_margins.py` filters);
    - "programs": per `evaluate_cycle` call in the body's order, the
      kinematics mode ("low_vel"), "quintic" (the stopping matrix), "group"
      (the sampling level, or "stop") and per agent "wanted" (a row of the
      matrix is unmasked: for the stopping matrix, the agent wants it), the
      matrix and mask, the selection (`best`, `found`, `selectable`, `cost`,
      after a post-pass), `inf_slots`, the lowest `s_vel` of each candidate
      and "idx" (the selected row, the emergency ladder's where nothing was
      found);
    - "merges": each `_merge` in order with its "kind" ("mode": v <
      low_vel_mode_threshold, "level": the next level where nothing was
      found, "stop": wants & the stopping program found) and "take" (A,);
    - "source" (A,): the program each agent's selection came from;
    - "fsm": the FSM outputs the cycle consumed, per agent ("state" code of
      behavior_state_static, "desired_velocity", "stop_s", "stop_v"), or
      None without the FSM in the run."""

    run_module: object
    cycles: list = field(default_factory=list)

    def __enter__(self):
        mod, trace = self.run_module, self
        self._saved = (mod.evaluate_cycle, mod.select_with_fallback, mod._merge,
                       mod._Runner.step)
        evaluate, select, merge, step = self._saved
        state = {"cur": None, "pending": None}

        def traced_evaluate(matrix, mask, ctx, **kw):
            res = evaluate(matrix, mask, ctx, **kw)
            if state["cur"] is not None:
                ro = res.rollout
                mask_np = _np(mask).astype(bool)
                state["pending"] = {
                    "low_vel": bool(kw.get("low_vel_mode", False)),
                    "quintic": bool(kw.get("quintic_lon", False)),
                    "wanted": mask_np.any(axis=-1), "matrix": _np(matrix),
                    "mask": mask_np, "slots": _np(ro.inf_slots).astype(bool),
                    "s_vel_min": _np(ro.s_vel).min(axis=-1)}
            return res

        def traced_select(res, matrix, mask, d0, emergency, risks=None, **kw):
            out = select(res, matrix, mask, d0, emergency, risks, **kw)
            cur = state["cur"]
            if cur is not None:
                prog, state["pending"] = state["pending"], None
                prog.update(best=_np(res.best_idx).astype(np.int64),
                            found=_np(res.found).astype(bool),
                            idx=_np(out["best"]).astype(np.int64),
                            selectable=_np(res.selectable).astype(bool),
                            cost=_np(res.cost))
                n_regular = sum(1 for q in cur["programs"] if not q["quintic"]) // 2
                prog["group"] = "stop" if prog["quintic"] else n_regular
                cur["programs"].append(prog)
                k = len(cur["programs"]) - 1
                cur["_src"][id(out)] = (out, np.full(prog["found"].shape, k), True)
            return out

        def traced_merge(take_b, a, b):
            out = merge(take_b, a, b)
            cur = state["cur"]
            if cur is not None:
                src = cur["_src"]
                (_, sa, raw_a), (_, sb, raw_b) = src[id(a)], src[id(b)]
                take = _np(take_b).astype(bool)
                if raw_a and raw_b:          # the two kinematics modes of a program
                    kind = "mode"
                else:
                    kind = "stop" if cur["programs"][int(sb.flat[0])]["quintic"] \
                        else "level"
                cur["merges"].append({"kind": kind, "take": take})
                src[id(out)] = (out, np.where(take, sb, sa), False)
                cur["_last"] = id(out)
            return out

        def traced_step(runner):
            p = runner.p
            if runner.nl or p.mesh is not None:
                raise ValueError("RunTrace traces the run of one scenario without a mesh")
            if runner.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("RunTrace traces eager runs only (run(graph=False))")
            c = int(runner.state["cycle"][0])
            cur = {"cycle": c, "agent_ids": [a.id for a in p.agents], "programs": [],
                   "merges": [], "fsm": None, "_src": {}, "_last": None}
            state["cur"] = cur
            fsm_step = p.fsm_step

            def traced_fsm(*args):
                carry, v_des, stop_s, stop_v = fsm_step(*args)
                cur["fsm"] = {"state": _np(carry.prev_type).astype(np.int64),
                              "desired_velocity": _np(v_des).astype(np.float64),
                              "stop_s": _np(stop_s).astype(np.float64),
                              "stop_v": _np(stop_v).astype(np.float64)}
                return carry, v_des, stop_s, stop_v

            p.fsm_step = traced_fsm
            try:
                step(runner)
            finally:
                p.fsm_step = fsm_step
                state["cur"] = None
            last = cur.pop("_last")
            src = cur.pop("_src")
            cur["source"] = src[last][1]
            steps = _np(runner.out["status_steps"][c])           # (k, A)
            cur["live"] = (steps == _RUNNING).any(axis=0)
            trace.cycles.append(cur)

        mod.evaluate_cycle = traced_evaluate
        mod.select_with_fallback = traced_select
        mod._merge = traced_merge
        mod._Runner.step = traced_step
        return self

    def __exit__(self, *exc):
        mod = self.run_module
        (mod.evaluate_cycle, mod.select_with_fallback, mod._merge,
         mod._Runner.step) = self._saved
        return False


@dataclass
class Parting:
    """The first level whose selection differs, and what decided it.  For a
    device run (`classify_run_parting`) `plan` is the cycle, `level` the try
    within it (the host's order) and `agent` the agent's id."""

    level: int
    plan: int
    kind: str                 # "tie", "threshold" or "unexplained"
    detail: str
    margins: dict = field(default_factory=dict)
    agent: object = None


def first_parting(a: CycleTrace, b: CycleTrace):
    """Index of the first level at which the two traces select differently
    (found or best_idx), or None when every common level agrees."""
    for i, (la, lb) in enumerate(zip(a.levels, b.levels)):
        if la["found"] != lb["found"] or (la["found"] and la["best"] != lb["best"]):
            return i
    return None


def _end_velocity(rows, dt: float, n_steps: int):
    """Stopping candidates' lowest longitudinal velocity over their steps,
    and the sum of the velocity polynomial's |terms| there, in float64 from
    their sampling rows ((K, 13) or one row; column 5 the end position, end
    velocity 0) as the rollout evaluates them
    (`ops.kinematics.rollout_candidates` with quintic_lon)."""
    r = torch.as_tensor(np.asarray(rows, dtype=np.float64)).reshape(-1, 13)
    c = poly.quintic_coeffs(r[:, 2], r[:, 3], r[:, 4], r[:, 5], torch.zeros_like(r[:, 5]),
                            r[:, 6], r[:, 1])
    traj_len = torch.clamp(torch.round(r[:, 1] / dt) + 1, 2, n_steps + 1)
    tgrid = torch.arange(n_steps + 1, dtype=torch.float64) * dt
    tau = torch.minimum(tgrid, ((traj_len - 1) * dt)[:, None])
    v = poly.poly_velocity(c, tau)
    j = torch.argmin(v, dim=-1, keepdim=True)
    t = torch.gather(tau, -1, j)
    terms = torch.cat([i * c[:, i:i + 1] * t ** (i - 1) for i in range(1, 6)], dim=-1)
    v_min = torch.gather(v, -1, j)[:, 0].numpy()
    s_terms = terms.abs().sum(-1).numpy()
    if np.ndim(rows) == 1:
        return float(v_min[0]), float(s_terms[0])
    return v_min, s_terms


def stopping_flips(trace, *, dt: float, n_steps: int):
    """(flagged, on target): over every stopping-mode level of `trace` (a
    CycleTrace, or a RunTrace's stopping tries of the agents that ran), the
    candidates whose exact (float64) lowest velocity is 0 within
    `ON_TARGET`, and how many of them the run's own arithmetic flagged as
    driving backwards (`s_vel < -1e-5`).  In float64 none is flagged; in
    float32 the share says how often rounding alone rejects a stopping
    candidate."""
    flagged = on_target = 0
    for lv in _all_levels(trace):
        if not lv["quintic"]:
            continue
        v64, _ = _end_velocity(lv["matrix"][lv["mask"]], dt, n_steps)
        hit = np.abs(v64) <= ON_TARGET
        on_target += int(hit.sum())
        flagged += int((hit & (lv["s_vel_min"][lv["mask"]] < -_EPS)).sum())
    return flagged, on_target


def _fsm_agrees(pa, pb):
    def close(x, y):
        return abs(x - y) <= FSM_RTOL * max(1.0, abs(x), abs(y))

    if pa["fsm_state"] != pb["fsm_state"]:
        return False
    if not close(pa["desired_velocity"], pb["desired_velocity"]):
        return False
    sa, sb = pa["stop_point"], pb["stop_point"]
    if (sa is None) != (sb is None):
        return False
    return sa is None or (close(sa[0], sb[0]) and close(sa[1], sb[1]))


def classify_parting(a: CycleTrace, b: CycleTrace, level: int, *,
                     dt: float, n_steps: int) -> Parting:
    """Name what decided the selection at `level` (see the module's
    docstring); `dt` and `n_steps` are the planner's."""
    la, lb = a.levels[level], b.levels[level]
    return _classify(la, lb, a.plans[la["plan"]], b.plans[lb["plan"]], level=level,
                     plan=la["plan"], dt=dt, n_steps=n_steps)


def _classify(la, lb, pa, pb, *, level, plan, dt, n_steps, agent=None,
              pairs=None) -> Parting:
    """The rules of `classify_parting` on two levels `la`, `lb` and the FSM
    outputs `pa`, `pb` they consumed (None without a behavior planner).
    `pairs`: the two selected candidates as (index in la, index in lb), by
    default the same index on both sides."""
    def parting(kind, detail, margins=None):
        return Parting(level, plan, kind, detail, margins or {}, agent)

    if (pa is None) != (pb is None) or (pa is not None and not _fsm_agrees(pa, pb)):
        return parting("unexplained", f"FSM outputs differ: {pa} vs {pb}")
    ba, bb = la["best"], lb["best"]
    if la["found"] != lb["found"]:
        return parting("unexplained", f"found {la['found']} vs {lb['found']}")
    pairs = pairs or ((ba, ba), (bb, bb))
    for ia, ib in pairs:
        if ia < 0 or ib < 0:
            return parting("unexplained", f"best {ba} vs {bb}: a selected candidate's "
                                          f"sampling row has no counterpart")
    flipped = [(ia, ib) for ia, ib in pairs if la["selectable"][ia] != lb["selectable"][ib]]
    if not flipped:
        (ka, _), (kb, _) = pairs
        cost_a = float(la["cost"][ka])
        gap = abs(cost_a - float(la["cost"][kb]))
        bound = ULPS * float(np.spacing(np.float32(abs(cost_a))))
        kind = "tie" if gap <= bound else "unexplained"
        return parting(kind, f"best {ba} vs {bb}, both selectable on both sides: cost gap "
                             f"{gap:.3e} against {ULPS} float32 ulps = {bound:.3e}",
                       {"cost_gap": gap, "bound": bound})
    margins = {}
    for ia, ib in flipped:
        slots = set(np.nonzero(la["slots"][ia] != lb["slots"][ib])[0].tolist())
        if not la["quintic"] or not lb["quintic"] or not slots <= VELOCITY_SIGN_SLOTS:
            return parting("unexplained",
                           f"candidate {ia} flips slots {sorted(slots)} "
                           f"(stopping mode {la['quintic']}/{lb['quintic']})")
        flagged, k = (la, ia) if not la["selectable"][ia] else (lb, ib)
        v32 = float(flagged["s_vel_min"][k])
        v64, terms = _end_velocity(flagged["matrix"][k], dt, n_steps)
        units = abs(v32 - v64) / (_U32 * terms)
        margins[ia] = {"s_vel_f32": v32, "s_vel_f64": v64, "threshold": -_EPS,
                       "rounding_units": units, "terms": terms}
        if not (v32 < -_EPS and abs(v64) <= ON_TARGET and units <= ROUNDING_UNITS):
            return parting("unexplained",
                           f"candidate {ia}: flagged s_vel {v32:.3e}, float64 {v64:.3e}, "
                           f"{units:.1f} rounding units", margins)
    text = "; ".join(
        f"candidate {k}: end velocity exactly {m['s_vel_f64']:.1e} in float64, "
        f"{m['s_vel_f32']:.3e} m/s in float32 against the -1e-5 test "
        f"({m['rounding_units']:.1f} rounding units of {m['terms']:.1f} m/s)"
        for k, m in margins.items())
    return parting("threshold", f"best {ba} vs {bb}: {text}", margins)


# ------------------------------------------------------- the device run's tries


def _agent_column(trace: RunTrace, agent_id):
    ids = trace.cycles[0]["agent_ids"] if trace.cycles else []
    return 0 if agent_id is None else ids.index(agent_id)


def _tries(trace, cycle: int, col: int = 0):
    """(levels, FSM outputs) of cycle `cycle` of `trace` in the host's
    order, as `CycleTrace` records them: for a CycleTrace the levels of plan
    call `cycle`; for a RunTrace the tries of the agent in column `col` (the
    stopping program where the agent wanted it, then the levels up to the
    first that found a candidate), each in the kinematics mode it took."""
    if isinstance(trace, CycleTrace):
        return [lv for lv in trace.levels if lv["plan"] == cycle], trace.plans[cycle]
    cyc = trace.cycles[cycle]
    progs, merges = cyc["programs"], [m for m in cyc["merges"] if m["kind"] == "mode"]
    # the program each group took for this agent: its mode merge's choice
    chosen = {}
    for g, m in enumerate(merges):
        chosen[progs[2 * g]["group"]] = 2 * g + int(m["take"][col])

    def level(k):
        lv = {key: (v[col] if isinstance(v, np.ndarray) else v)
              for key, v in progs[k].items()}
        lv.update(best=int(lv["best"]), found=bool(lv["found"]), idx=int(lv["idx"]),
                  plan=cycle, program=k)
        return lv

    tries = []
    if "stop" in chosen and progs[chosen["stop"]]["wanted"][col]:
        tries.append(level(chosen["stop"]))
    if not (tries and tries[0]["found"]):
        for g in sorted(k for k in chosen if k != "stop"):
            tries.append(level(chosen[g]))
            if tries[-1]["found"]:
                break
    if tries[-1]["program"] != cyc["source"][col]:
        raise RuntimeError(f"cycle {cycle}, column {col}: the host's order of tries ends "
                           f"at program {tries[-1]['program']}, the run's merges took "
                           f"{cyc['source'][col]}")
    fsm = cyc["fsm"]
    plan = None
    if fsm is not None:
        plan = {"desired_velocity": float(fsm["desired_velocity"][col]),
                "stop_point": (float(fsm["stop_s"][col]), float(fsm["stop_v"][col])),
                "fsm_state": _TYPE_NAME[int(fsm["state"][col])]}
    return tries, plan


def _all_levels(trace):
    """Every level of a CycleTrace; every try of every agent that ran in a
    RunTrace."""
    if isinstance(trace, CycleTrace):
        yield from trace.levels
        return
    for c, cyc in enumerate(trace.cycles):
        for col in np.nonzero(cyc["live"])[0]:
            yield from _tries(trace, c, int(col))[0]


def _row_map(la, lb):
    """For every candidate of `la`, the index of the candidate of `lb` with
    the same sampling row (columns t1, 5, d1 within MATCH_ULPS float32 ulps;
    the first such), or -1."""
    a = np.asarray(la["matrix"], np.float64)[:, _MATCH_COLS]
    b = np.asarray(lb["matrix"], np.float64)[:, _MATCH_COLS]
    scale = np.maximum(np.maximum(np.abs(a)[:, None], np.abs(b)[None]), 1.0)
    tol = MATCH_ULPS * np.spacing(scale.astype(np.float32)).astype(np.float64)
    same = np.all(np.abs(a[:, None] - b[None]) <= tol, axis=-1) & lb["mask"][None]
    return np.where(same.any(axis=1) & la["mask"], np.argmax(same, axis=1), -1)


def _same_try(la, lb, matched: bool) -> bool:
    if la["found"] != lb["found"]:
        return False
    if not la["found"]:
        return True
    if matched:
        return _row_map(la, lb)[la["best"]] == lb["best"]
    return la["best"] == lb["best"]


def _cycles(trace) -> int:
    return len(trace.plans) if isinstance(trace, CycleTrace) else len(trace.cycles)


def first_run_parting(a, b, *, agent_id=None):
    """The first (cycle, agent id) at which two traces part, or None.

    Both RunTraces: every agent; a pair parts where it ran on one side only,
    where its tries differ in number, `found` or selected candidate, or where
    the emergency ladder picked another row.  A RunTrace against a
    CycleTrace (a host run of one agent; either order): device cycle c
    against host plan call c, for the agent `agent_id` (default: the run's
    first agent), candidates matched by their sampling row."""
    run = a if isinstance(a, RunTrace) else b
    matched = isinstance(a, CycleTrace) or isinstance(b, CycleTrace)
    if matched:
        cols = [(_agent_column(run, agent_id), None)]
    else:
        cols = [(col, aid) for col, aid in enumerate(run.cycles[0]["agent_ids"])] \
            if run.cycles else []
    for c in range(min(_cycles(a), _cycles(b))):
        for col, aid in cols:
            live = [True if isinstance(t, CycleTrace) else bool(t.cycles[c]["live"][col])
                    for t in (a, b)]
            if live[0] != live[1]:
                return c, _agent_id(run, col)
            if not live[0]:
                continue
            ta, tb = _tries(a, c, col)[0], _tries(b, c, col)[0]
            if len(ta) != len(tb) or not all(_same_try(x, y, matched)
                                             for x, y in zip(ta, tb)):
                return c, _agent_id(run, col)
            if not matched and not ta[-1]["found"] and ta[-1]["idx"] != tb[-1]["idx"]:
                return c, _agent_id(run, col)
    return None


def _agent_id(run: RunTrace, col: int):
    return run.cycles[0]["agent_ids"][col]


def classify_run_parting(a, b, cycle: int, agent_id=None, *, dt: float,
                         n_steps: int) -> Parting:
    """Name what decided the parting that `first_run_parting` found at
    (`cycle`, `agent_id`): the rules of `classify_parting`, applied to the
    first try of that cycle whose selection differs, with the FSM outputs
    each side consumed; the selected candidates are matched by their
    sampling row where one side is a host trace."""
    run = a if isinstance(a, RunTrace) else b
    col = _agent_column(run, agent_id)
    aid = _agent_id(run, col)
    matched = isinstance(a, CycleTrace) or isinstance(b, CycleTrace)
    live = [True if isinstance(t, CycleTrace) else bool(t.cycles[cycle]["live"][col])
            for t in (a, b)]
    if live[0] != live[1]:
        return Parting(0, cycle, "unexplained",
                       f"agent {aid} ran cycle {cycle} on one side only ({live})",
                       agent=aid)
    (ta, pa), (tb, pb) = _tries(a, cycle, col), _tries(b, cycle, col)
    for i, (la, lb) in enumerate(zip(ta, tb)):
        if _same_try(la, lb, matched):
            continue
        pairs = None
        if matched:
            ab, ba = _row_map(la, lb), _row_map(lb, la)
            pairs = ((la["best"], int(ab[la["best"]])), (int(ba[lb["best"]]), lb["best"]))
        return _classify(la, lb, pa, pb, level=i, plan=cycle, dt=dt, n_steps=n_steps,
                         agent=aid, pairs=pairs)
    if len(ta) != len(tb):
        return Parting(min(len(ta), len(tb)), cycle, "unexplained",
                       f"agent {aid}: {len(ta)} tries against {len(tb)} "
                       f"(stopping wanted on one side only?)", agent=aid)
    return Parting(len(ta) - 1, cycle, "unexplained",
                   f"agent {aid}: the emergency ladder picked row {ta[-1]['idx']} against "
                   f"{tb[-1]['idx']}", agent=aid)
