"""Whether the answers the window produced are right: each sampled answer
against the plain reference in float64, after the window has closed.

Per agent of each checked request:

- `found_mismatch`: the program found a selectable candidate where the
  reference found none, or the other way round (a count);
- `pick_gap`: how much worse the program's pick is under the reference's
  costs than the reference's own pick, over max(|its cost|, 1); a pick
  that the reference does not hold selectable reads `UNSELECTABLE`;
- `traj_err_m`: the widest gap between the program's selected trajectory
  (x, y, s, d at every step) and the reference's rollout of the same
  candidate;
- `cost_err_rel`: the program's cost of its pick against the reference's,
  over max(|reference cost|, 1);
- `hist_diff`: the widest gap of the 11-slot infeasibility histogram, as a
  share of the real candidates.

Where the configuration weights responsibility, also per checked request:

- `resp_err_rel`: the risk stack's term in every real candidate's cost
  (the term the program's post-pass added to each cost, times its weight,
  against the reference's):
  Σ |program − reference| over Σ |reference| (at least `RESP_FLOOR`), over
  the real candidates of all agents of the request.  Collision probability,
  harm and the reach sets enter it for every candidate, not only the pick.
  Left out are the candidates whose longitudinal speed comes within
  `ON_THRESHOLD` of the speed at which the heading stops following the path
  (`reference.cycle.MOVING`): the stopping samples end at exactly that
  speed, so which side of it a step falls on, and with it the heading the
  quadrature's rectangles take, is decided by rounding.

Each number is the largest over all checked agents (requests) and is held
to the limit in `limits/<config>.json`; the numbers of a configuration are
those its limits file names.  A configuration that names a `check` is held
by `checks/<name>.py` instead (`compare_one`), to the numbers that module
lists; a limits file that names any other number is refused.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np
import torch

from portbench import reference
from portbench.reference import cycle

UNSELECTABLE = 1.0e9
NUMBERS = ("found_mismatch", "pick_gap", "traj_err_m", "cost_err_rel", "hist_diff",
           "resp_err_rel")
RESP_FLOOR = 1.0e-6                # cost units: a term summing to less is noise
ON_THRESHOLD = 1.0e-4              # m/s
_S_VEL = 7                         # s_vel in the reference's row order
_POSITION_ROWS = (0, 1, 6, 9)      # x, y, s, d in the program's row order


def check_of(config):
    """The module of the configuration's own `check`, or None."""
    name = config.get("check")
    return None if name is None else importlib.import_module(f"portbench.checks.{name}")


def numbers_of(config) -> tuple:
    """The names of the numbers the configuration's comparison computes."""
    check = check_of(config)
    return NUMBERS if check is None else tuple(check.NUMBERS)


def limits(config_name: str, config=None) -> dict:
    """The limits file of `config_name`, in the order of its numbers; a key
    that names no number of the configuration's comparison raises.
    `config` defaults to the configuration's file."""
    here = Path(__file__).resolve().parent
    if config is None:
        config = json.loads((here / "configs" / f"{config_name}.json").read_text())
    data = json.loads((here / "limits" / f"{config_name}.json").read_text())
    names = numbers_of(config)
    unknown = sorted(set(data) - set(names))
    if unknown:
        raise ValueError(f"limits/{config_name}.json names {unknown}, which the "
                         f"comparison of {config_name!r} does not compute: {list(names)}")
    return {k: float(data[k]) for k in names if k in data}


def sample(n_done: int, k: int, seed: int) -> list[int]:
    """`k` window indices drawn from the seed (all when fewer)."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    if n_done <= k:
        return list(range(n_done))
    return sorted(rng.choice(n_done, size=k, replace=False).tolist())


def reference_answer(config, lines, req, *, dtype, device) -> dict:
    """The reference's own answer in the program's form (the control)."""
    ref = reference.solve(config, lines, req, dtype=dtype, device=device)
    best = ref["best"]
    return dict(found=np.array(ref["found"]), best=np.array(best),
                cost=np.array([float(c[b]) for c, b in zip(ref["cost"], best)]),
                rows=np.stack([r[:, b].double().cpu().numpy()
                               for r, b in zip(ref["rows"], best)]),
                hist=np.stack([h.cpu().numpy() for h in ref["hist"]]),
                resp=np.stack([r.double().cpu().numpy() for r in ref["resp"]]))


def compare(config, lines, checked, *, device) -> dict:
    """The numbers over `checked` = [(request, answer)]."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for req, ans in checked:
        ref = reference.solve(config, lines, req, dtype=torch.float64, device=device)
        if config.get("responsibility", 0.0):
            out["resp_err_rel"] = max(out["resp_err_rel"], _resp_err_rel(ans, ref))
        for a in range(config["agents"]):
            hist = np.abs(np.asarray(ans["hist"][a]) - ref["hist"][a].cpu().numpy())
            out["hist_diff"] = max(out["hist_diff"], float(hist.max()) / ref["n_valid"][a])
            if bool(ans["found"][a]) != ref["found"][a]:
                out["found_mismatch"] += 1
                continue
            if not ref["found"][a]:
                continue
            cost = ref["cost"][a].cpu().numpy()
            b = int(ans["best"][a])
            if not 0 <= b < cost.shape[0] or not bool(ref["selectable"][a][b]):
                out["pick_gap"] = UNSELECTABLE
                continue
            best_cost = cost[ref["best"][a]]
            out["pick_gap"] = max(out["pick_gap"],
                                  (cost[b] - best_cost) / max(abs(best_cost), 1.0))
            rows = ref["rows"][a][list(_POSITION_ROWS), b].cpu().numpy()
            got = np.asarray(ans["rows"][a])[list(_POSITION_ROWS)]
            out["traj_err_m"] = max(out["traj_err_m"], float(np.abs(got - rows).max()))
            out["cost_err_rel"] = max(out["cost_err_rel"],
                                      abs(float(ans["cost"][a]) - cost[b])
                                      / max(abs(cost[b]), 1.0))
    return {k: float(v) for k, v in out.items()}


def compare_one(config, lines, req, ans, *, device) -> dict:
    """The numbers of one sampled answer: the configuration's own check,
    or `compare` above."""
    check = check_of(config)
    if check is None:
        return compare(config, lines, [(req, ans)], device=device)
    got = check.compare(config, lines, req, ans, device=device)
    missing = sorted(set(check.NUMBERS) - set(got))
    if missing:
        raise ValueError(f"check {config['check']!r} computed no {missing}")
    return {k: float(v) for k, v in got.items()}


def fold(numbers: dict, got: dict) -> None:
    """Fold one answer's numbers `got` into `numbers`: `found_mismatch` is
    summed, every other number takes the largest."""
    for name, v in got.items():
        numbers[name] = (numbers.get(name, 0.0) + v if name == "found_mismatch"
                         else max(numbers.get(name, 0.0), v))


def _resp_err_rel(ans, ref) -> float:
    """One request's `resp_err_rel` (an answer without the term reads inf)."""
    if "resp" not in ans:
        return float("inf")
    diff = total = 0.0
    for a, (term, mask) in enumerate(zip(ref["resp"], ref["mask"])):
        s_vel = ref["rows"][a][_S_VEL].cpu().numpy()
        keep = mask & ~np.any(np.abs(s_vel - cycle.MOVING) < ON_THRESHOLD, axis=-1)
        want = term.cpu().numpy()[keep]
        got = np.asarray(ans["resp"][a], np.float64)[keep]
        diff += float(np.abs(got - want).sum())
        total += float(np.abs(want).sum())
    return diff / max(total, RESP_FLOOR)


def verdict(numbers: dict, lims: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= lims[k] for k in lims)
