"""The device-resident fleet run's answers against the plain closed-loop
reference (`reference/fleet.py` over `reference/run.py`), in float64 after
the window.

Per checked fleet, one member of each family, drawn from the fleet's own
numbers (its members' ego speeds).  Each such member is checked as
`checks/device_run.py` checks a convoy, over the member's own Setup: its
`check_cycles` live cycles solved again by the reference from the
program's own state at the cycle's start, with the same numbers and
limits, and its statuses held to the reference's goal check and in-order
collision sweep on the program's executed poses.  `found_mismatch` and
`status_mismatch` are counts summed over the checked members; every other
number is the largest over them.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.checks import device_run as one
from portbench.judge import UNSELECTABLE
from portbench.reference import fleet as fref
from portbench.reference import run as ref

NUMBERS = one.NUMBERS
SUMMED = ("found_mismatch", "status_mismatch")


def checked_members(request) -> list[int]:
    """One member of each family in the fleet, drawn from its ego speeds."""
    members = request["members"]
    bits = np.array([m["ego_v"] for m in members], np.float64).view(np.uint64)
    rng = np.random.default_rng([int(b) for b in bits])
    families = list(dict.fromkeys(m["family"] for m in members))
    picks = []
    for fam in families:
        of_fam = [i for i, m in enumerate(members) if m["family"] == fam]
        picks.append(of_fam[int(rng.integers(len(of_fam)))])
    return sorted(picks)


def member_numbers(config, member, answer, *, device) -> dict:
    """`checks/device_run.py`'s numbers of one member's answer: its
    `compare` loop over the member's own Setup (`compare` builds its Setup
    from one lane)."""
    su = fref.setup(config, member)
    wb = su.veh.wb_rear_axle
    out = dict.fromkeys(NUMBERS, 0.0)
    n_cycles = len(answer["x_cl"])
    for c in one.checked_cycles(config, member, answer):
        states = dict(x_cl=answer["x_cl"][c], pose=one._pose_at(su, answer, c),
                      status=one._status_at(su, answer, c))
        plans, status = ref._solve(su, c, states, one.peers_bank(su, answer, c, device),
                                   dtype=torch.float64, device=device)
        for a in np.flatnonzero(status == ref.RUNNING):
            pl, found = plans[a], bool(answer["found"][c][a])
            if found != pl.found:
                out["found_mismatch"] += 1
                continue
            j = one._match(pl.matrix, answer["sel"][c][a])
            cost = pl.cost.double().cpu().numpy()
            if j is None or (found and not bool(pl.selectable[j])) or (
                    not found and one._match(pl.matrix[j:j + 1], pl.sel.cpu().numpy()) is None):
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
            done = one._executed(answer, su, c, a, int(status[a]))
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
    out["status_mismatch"] = float(one.status_mismatch(su, answer))
    return {k: float(v) for k, v in out.items()}


def compare(config, lines, request, answer, *, device) -> dict:
    out = dict.fromkeys(NUMBERS, 0.0)
    for i in checked_members(request):
        got = member_numbers(config, request["members"][i], answer["members"][i],
                             device=device)
        for k, v in got.items():
            out[k] = out[k] + v if k in SUMMED else max(out[k], v)
    return out


def control_answer(config, lines, request, *, dtype, device):
    """The reference's own free-running runs of the checked members in
    `dtype`, in the entry's form."""
    return fref.simulate_fleet(config, request, checked_members(request), dtype=dtype,
                               device=device)
