"""Where two float32 runs of the host planner part, and what decided it.

Two runs of the same scenario in float32 (the port on the card and on the
CPU, or the port and the JAX package) round differently, so their executed
states differ by a few ulps from the first step.  Such runs part for real
only at a cycle whose selection differs.  `CycleTrace` records every
`evaluate_cycle` call of a planner module, `first_parting` finds the first
cycle whose selection differs, and `classify_parting` names what decided
it.  Two causes are accepted as float32 rounding, not as a fault:

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

The tracer patches the `evaluate_cycle` name of a planner module, the
`plan` method of its `ReactivePlanner` and, where given, the `execute`
method of a behavior module's `BehaviorModule`; it works on any modules
with the port's interface and records numpy arrays only.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from frenetix_tpu_torch.ops import polynomials as poly

__all__ = ["CycleTrace", "Parting", "classify_parting", "first_parting",
           "stopping_flips"]

ULPS = 4
ON_TARGET = 1e-9          # m/s: the float64 end velocity of a stopping row
ROUNDING_UNITS = 32       # float32 rounding units of the velocity polynomial
FSM_RTOL = 1e-4
VELOCITY_SIGN_SLOTS = frozenset({0, 2, 4, 6, 10})
_U32 = 2.0 ** -24
_EPS = 1e-5               # ops.kinematics._EPS: the negative-velocity test


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
class Parting:
    """The first level whose selection differs, and what decided it."""

    level: int
    plan: int
    kind: str                 # "tie", "threshold" or "unexplained"
    detail: str
    margins: dict = field(default_factory=dict)


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


def stopping_flips(trace: CycleTrace, *, dt: float, n_steps: int):
    """(flagged, on target): over every stopping-mode level of `trace`, the
    candidates whose exact (float64) lowest velocity is 0 within
    `ON_TARGET`, and how many of them the run's own arithmetic flagged as
    driving backwards (`s_vel < -1e-5`).  In float64 none is flagged; in
    float32 the share says how often rounding alone rejects a stopping
    candidate."""
    flagged = on_target = 0
    for lv in trace.levels:
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
    plan = la["plan"]
    pa, pb = a.plans[plan], b.plans[lb["plan"]]
    if not _fsm_agrees(pa, pb):
        return Parting(level, plan, "unexplained",
                       f"FSM outputs differ: {pa} vs {pb}")
    ba, bb = la["best"], lb["best"]
    if la["found"] != lb["found"]:
        return Parting(level, plan, "unexplained",
                       f"found {la['found']} vs {lb['found']}")
    flipped = [k for k in (ba, bb) if la["selectable"][k] != lb["selectable"][k]]
    if not flipped:
        gap = abs(la["cost"][ba] - la["cost"][bb])
        bound = ULPS * float(np.spacing(np.float32(abs(la["cost"][ba]))))
        kind = "tie" if gap <= bound else "unexplained"
        return Parting(level, plan, kind,
                       f"best {ba} vs {bb}, both selectable on both sides: cost gap "
                       f"{gap:.3e} against {ULPS} float32 ulps = {bound:.3e}",
                       {"cost_gap": gap, "bound": bound})
    margins = {}
    for k in flipped:
        slots = set(np.nonzero(la["slots"][k] != lb["slots"][k])[0].tolist())
        if not la["quintic"] or not lb["quintic"] or not slots <= VELOCITY_SIGN_SLOTS:
            return Parting(level, plan, "unexplained",
                           f"candidate {k} flips slots {sorted(slots)} "
                           f"(stopping mode {la['quintic']}/{lb['quintic']})")
        flagged = la if not la["selectable"][k] else lb
        v32 = flagged["s_vel_min"][k]
        v64, terms = _end_velocity(flagged["matrix"][k], dt, n_steps)
        units = abs(v32 - v64) / (_U32 * terms)
        margins[k] = {"s_vel_f32": v32, "s_vel_f64": v64, "threshold": -_EPS,
                      "rounding_units": units, "terms": terms}
        if not (v32 < -_EPS and abs(v64) <= ON_TARGET and units <= ROUNDING_UNITS):
            return Parting(level, plan, "unexplained",
                           f"candidate {k}: flagged s_vel {v32:.3e}, float64 {v64:.3e}, "
                           f"{units:.1f} rounding units", margins)
    text = "; ".join(
        f"candidate {k}: end velocity exactly {m['s_vel_f64']:.1e} in float64, "
        f"{m['s_vel_f32']:.3e} m/s in float32 against the -1e-5 test "
        f"({m['rounding_units']:.1f} rounding units of {m['terms']:.1f} m/s)"
        for k, m in margins.items())
    return Parting(level, plan, "threshold", f"best {ba} vs {bb}: {text}", margins)
