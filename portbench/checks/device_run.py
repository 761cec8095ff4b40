"""The device-resident run's answers against the plain closed-loop
reference (`reference/run.py`), in float64 after the window.

For each checked request, `check_cycles` cycles drawn from the request
(and so from the seed) among its live cycles, those in which some agent
executes a step (the answer's statuses: a scenario whose agents have all
finished runs on to its last cycle), every agent that runs after the
cycle's goal check:
the cycle solved again by the reference from the program's own state at
its start (replan state, pose and statuses as the answer reports them),
with the peers' plans the reference rolls out itself from their picks at
the cycle before (before the first plan, the vehicles' recorded
trajectories).  The program's pick is matched in the reference's matrix by
its (t1, ṡ1, d1).  Numbers:

- `found_mismatch`: the program found a selectable candidate where the
  reference found none, or the other way round (a count);
- `pick_gap`: how much worse the program's pick is under the reference's
  costs than the reference's own, over max(|its cost|, 1); a pick the
  reference does not hold selectable, or without a match, reads
  `UNSELECTABLE`, and so does an emergency pick other than the reference's
  ladder's;
- `traj_err_m`: the widest gap between the vehicle centres the program
  executed in the cycle and the reference's rollout of the pick;
- `cost_err_rel`: the program's cost of its pick against the reference's,
  over max(|reference cost|, 1);
- `transition_m`: the widest gap of s and d between the program's replan
  state at the next cycle and the reference's rollout of the pick after
  `replanning_frequency` steps (agents that executed them all);

and over the whole request:

- `status_mismatch`: the agents whose status at some step, or at the end,
  differs from the reference's goal check and in-order collision sweep on
  the program's executed poses (a count).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.judge import UNSELECTABLE
from portbench.reference import run as ref

NUMBERS = ("found_mismatch", "pick_gap", "traj_err_m", "cost_err_rel", "transition_m",
           "status_mismatch")
MATCH_TOL = 1e-4        # of a sampled (t1, ṡ1, d1) in float32 against float64


def live_cycles(config, answer) -> np.ndarray:
    """The cycles in which some agent executes the cycle's first step: it
    runs at the cycle's start and its status after that step is running or
    collided (not reached its goal, not stopped by the time limit)."""
    k = int(config["planning"]["replanning_frequency"])
    sps = np.asarray(answer["status_steps"])
    n_cycles = len(answer["x_cl"])
    first = np.minimum(np.arange(n_cycles) * k, len(sps) - 1)
    before = np.concatenate([np.full((1, sps.shape[1]), ref.RUNNING), sps[first[1:] - 1]])
    after = sps[first]
    ran = (before == ref.RUNNING) & np.isin(after, (ref.RUNNING, ref.COLLISION))
    return np.flatnonzero(ran.any(axis=1))


def checked_cycles(config, request, answer) -> list[int]:
    """The cycles checked in `request`: `check_cycles` of its live cycles,
    drawn from the request's own numbers."""
    bits = np.array([request["ego_v"], request["gap"]], np.float64).view(np.uint64)
    rng = np.random.default_rng([int(b) for b in bits])
    live = live_cycles(config, answer)
    n = min(int(config["check_cycles"]), len(live))
    return sorted(live[rng.choice(len(live), size=n, replace=False)].tolist())


def _pose_at(su, answer, c):
    """(A, 5) the poses at cycle c's start: centre x, y, θ, v, a."""
    if c == 0:
        return np.column_stack([su.pose0, np.zeros(len(su.pose0))])
    return np.asarray(answer["traj"][c * su.k - 1], np.float64)


def _status_at(su, answer, c):
    if c == 0:
        return np.full(len(su.pose0), ref.RUNNING)
    return np.asarray(answer["status_steps"][c * su.k - 1])


def _pick_row(x_cl, sel):
    """(1, 13) the sampling row of a pick (t1, ṡ1, d1) from replan state x_cl."""
    s0, ss0, sss0, d0, dd0, ddd0 = x_cl
    return np.array([[0.0, sel[0], s0, ss0, sss0, sel[1], 0.0, d0, dd0, ddd0, sel[2],
                      0.0, 0.0]])


def peers_bank(su, answer, c, device):
    """The plan bank cycle c reads: each agent's pick at c − 1 rolled out
    by the reference from its replan state then (a standstill agent's pose
    at v = 0), or before the first plan the set-up's."""
    if c == 0:
        return dict(bank=su.bank0, bank_len=su.bank_len0)
    p = su.config["planning"]
    pose = _pose_at(su, answer, c - 1)
    status = _status_at(su, answer, c - 1)
    running = ((status == ref.RUNNING)
               & ~ref.goal_reached(su, pose[:, :2], pose[:, 3]))
    tab = su.table(torch.float64, device)
    plans = []
    for a in range(len(pose)):
        matrix = torch.as_tensor(_pick_row(answer["x_cl"][c - 1][a], answer["sel"][c - 1][a]),
                                 dtype=torch.float64, device=device)
        ro = ref.rollout(matrix, tab, su.veh, float(pose[a, 2]), dt=p["dt"],
                         n_steps=su.n_steps, window=su.config["road"]["table_window"],
                         low_vel=pose[a, 3] < p["low_vel_mode_threshold"])
        plans.append(ref.Plan(matrix, ro, None, None, None, True, True, 0))
    std = running & ~np.asarray(answer["found"][c - 1], bool) & (pose[:, 3] <= 0.1)
    bank, bank_len = ref.bank_of(su, plans, pose, std)
    return dict(bank=bank, bank_len=bank_len)


def _match(matrix, sel):
    """The first row of `matrix` whose (t1, ṡ1, d1) is `sel`, or None."""
    cols = matrix[:, [1, 5, 10]].double().cpu().numpy()
    hit = np.all(np.abs(cols - np.asarray(sel, np.float64))
                 <= MATCH_TOL * np.maximum(1.0, np.abs(cols)), axis=1)
    return int(np.argmax(hit)) if hit.any() else None


def _executed(answer, su, c, a, status_start):
    """Per sub-step j = 1..k of cycle c, whether agent a executed it."""
    sps, out = answer["status_steps"], []
    prev = status_start
    for j in range(1, su.k + 1):
        t = c * su.k + j
        if t > len(sps):
            out.append(False)
            continue
        now = int(sps[t - 1][a])
        out.append(prev == ref.RUNNING and now in (ref.RUNNING, ref.COLLISION))
        prev = now
    return out


def status_mismatch(su, answer) -> int:
    """The agents whose statuses differ from the reference's ladder on the
    program's executed poses (see the module's doc)."""
    traj, sps = np.asarray(answer["traj"], np.float64), np.asarray(answer["status_steps"])
    pose = _pose_at(su, answer, 0)
    status = np.full(len(pose), ref.RUNNING)
    bad = np.zeros(len(pose), bool)
    for t in range(len(traj)):
        running = status == ref.RUNNING
        status = np.where(ref.goal_reached(su, pose[:, :2], pose[:, 3]) & running,
                          ref.SUCCESS, status)
        pose = traj[t]
        marked = ref.collision_step(su, t + 1, pose[:, :2], pose[:, 2],
                                    status == ref.RUNNING)
        status = np.where(marked, ref.COLLISION, status)
        bad |= status != sps[t]
    final = np.where(status == ref.RUNNING, ref.TIMELIMIT, status)
    return int(np.sum(bad | (final != np.asarray(answer["status"]))))


def compare(config, lines, request, answer, *, device) -> dict:
    su = ref.setup(config, lines[0], request)
    wb = su.veh.wb_rear_axle
    out = dict.fromkeys(NUMBERS, 0.0)
    n_cycles = len(answer["x_cl"])
    for c in checked_cycles(config, request, answer):
        states = dict(x_cl=answer["x_cl"][c], pose=_pose_at(su, answer, c),
                      status=_status_at(su, answer, c))
        plans, status = ref.solve_cycle(config, request, c, states,
                                        peers_bank(su, answer, c, device), lines=lines,
                                        device=device)
        for a in np.flatnonzero(status == ref.RUNNING):
            pl, found = plans[a], bool(answer["found"][c][a])
            if found != pl.found:
                out["found_mismatch"] += 1
                continue
            j = _match(pl.matrix, answer["sel"][c][a])
            cost = pl.cost.double().cpu().numpy()
            if j is None or (found and not bool(pl.selectable[j])) or (
                    not found and _match(pl.matrix[j:j + 1], pl.sel.cpu().numpy()) is None):
                out["pick_gap"] = UNSELECTABLE
                continue
            if found:
                best = cost[pl.idx]
                out["pick_gap"] = max(out["pick_gap"],
                                      (cost[j] - best) / max(abs(best), 1.0))
            out["cost_err_rel"] = max(out["cost_err_rel"],
                                      abs(float(answer["cost"][c][a]) - cost[j])
                                      / max(abs(cost[j]), 1.0))
            if not found and states["pose"][a, 3] <= 0.1:
                continue                     # a standstill agent holds its pose
            rows = pl.rows(j).double().cpu().numpy()
            done = _executed(answer, su, c, a, int(status[a]))
            for step, ran in enumerate(done, start=1):
                if ran:
                    th = rows[2, step]
                    want = (rows[0, step] + wb * np.cos(th), rows[1, step] + wb * np.sin(th))
                    got = answer["traj"][c * su.k + step - 1][a][:2]
                    out["traj_err_m"] = max(out["traj_err_m"],
                                            float(np.abs(np.asarray(got) - want).max()))
            if all(done) and c + 1 < n_cycles:
                nxt = np.asarray(answer["x_cl"][c + 1][a])[[0, 3]]
                gap = np.abs(nxt - rows[[6, 9], su.k]).max()
                out["transition_m"] = max(out["transition_m"], float(gap))
    out["status_mismatch"] = float(status_mismatch(su, answer))
    return {k: float(v) for k, v in out.items()}


def control_answer(config, lines, request, *, dtype, device):
    """The reference's own free-running run in `dtype`, in the entry's form."""
    return ref.simulate(config, request, lines=lines, dtype=dtype, device=device)
