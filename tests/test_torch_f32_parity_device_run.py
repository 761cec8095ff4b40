"""The port's float32 device-resident run against the port's float32 host
run on the CPU: `traffic_light` and `stop_sign` with the behavior planner at
their default size, the FSM in the run.

The host run is held against the JAX package's float32 host run in
`test_torch_f32_parity_{traffic_light,stop_sign}.py`; this file chains the
device run to it.  Both runs take the same steps with the same statuses.
They part at one cycle each: traffic_light at cycle 6 (the step 18 cycle),
stop_sign at cycle 10 (the step 30 cycle), before the light and the sign.
Up to it the executed positions agree within 1e-4 m.  At that cycle the
FSM's outputs agree, and the two runs select different stopping candidates
because float32 rounding flips the negative-velocity test (`s_vel < -1e-5`)
of a candidate whose exact end velocity is 0 (`utils.parting`,
"threshold").  The device run is traced by `RunTrace`, the host run by
`CycleTrace`; the device's stopping matrix keeps a duplicate row that the
host's drops, so candidates are matched by their sampling row.

Below, classifier unit tests on crafted traces: a real negative velocity, a
curvature flip, a differing FSM state and a cost gap beyond 4 float32 ulps
are each "unexplained", and a stopping row at another index is matched by
its value.  Each run is made once for the module.
"""
import numpy as np
import pytest
import torch

from torch_parity import CPU, host_count, statuses

torch.set_num_threads(1)

# family: (steps of both runs, the cycle at which they part)
EXPECTED = {"traffic_light": (151, 6), "stop_sign": (160, 10)}
POS_TOL = 1e-4
DT, N_STEPS, K_REPLAN = 0.1, 30, 3


def _sim(family):
    from frenetix_tpu_torch.io import scenario_factory
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.dtype = "float32"
    cfg.behavior.use_behavior_planner = True
    return Simulation(getattr(scenario_factory, f"make_{family}")(), cfg, CPU)


@pytest.fixture(scope="module", params=sorted(EXPECTED))
def runs(request):
    """(family, device result, its RunTrace, host result, its CycleTrace)."""
    from frenetix_tpu_torch.behavior import behavior_module
    from frenetix_tpu_torch.parallel import device_sim
    from frenetix_tpu_torch.planner import reactive
    from frenetix_tpu_torch.utils.parting import CycleTrace, RunTrace

    family = request.param
    ds = device_sim.DeviceSimulation(_sim(family))
    assert ds.fsm_in_scan, ds.fsm_reason
    fetches = host_count("device_sim.fetches")
    with RunTrace(device_sim) as run_trace:
        dres = ds.run(graph=False)
    assert host_count("device_sim.fetches") == fetches + 1, "the traced run still fetches once"
    with CycleTrace(reactive, behavior_module) as host_trace:
        hres = _sim(family).run()
    return family, dres, run_trace, hres, host_trace


def test_device_run_float32_steps_and_statuses_match_the_host_run(runs):
    family, dres, _, hres, _ = runs
    assert dres.steps == hres.steps == EXPECTED[family][0]
    assert {aid: int(s) for aid, s in zip(dres.agent_ids, dres.status)} == statuses(hres)
    assert hres.success


def test_device_run_float32_parts_from_the_host_run_at_a_threshold_flip(runs):
    from frenetix_tpu_torch.utils.parting import classify_run_parting, first_run_parting

    family, dres, run_trace, hres, host_trace = runs
    ego = dres.agent_ids[0]
    hit = first_run_parting(run_trace, host_trace)
    assert hit == (EXPECTED[family][1], ego)
    cycle = hit[0]
    parting = classify_run_parting(run_trace, host_trace, cycle, ego, dt=DT, n_steps=N_STEPS)
    assert parting.kind == "threshold", parting.detail
    for cand, m in parting.margins.items():
        # the stopping candidate's exact end velocity is 0 ...
        assert abs(m["s_vel_f64"]) <= 1e-9, (cand, m)
        # ... and float32 rounding put it beyond the -1e-5 test on one side
        assert m["s_vel_f32"] < -1e-5, (cand, m)
        assert m["rounding_units"] <= 32, (cand, m)
    # the executed states agree up to the parting cycle's step
    step = K_REPLAN * cycle
    pos = np.array([s.position for s in hres.histories[ego][1:step + 1]])
    np.testing.assert_allclose(dres.trajectories[:step, 0, :2], pos, rtol=0, atol=POS_TOL)
    # the parting cycle plans in stopping mode on both sides, from one FSM state
    run_cycle = run_trace.cycles[cycle]
    assert run_cycle["live"][0] and run_cycle["fsm"] is not None
    assert host_trace.plans[cycle]["fsm_state"] is not None


def test_device_run_float32_rejects_stopping_candidates_as_the_host_run_does(runs):
    """Of the stopping candidates whose exact end velocity is 0, float32
    flags a like share as reversing in the device run and in the host run."""
    from frenetix_tpu_torch.utils.parting import stopping_flips

    _, _, run_trace, _, host_trace = runs
    shares = []
    for trace in (run_trace, host_trace):
        flagged, on_target = stopping_flips(trace, dt=DT, n_steps=N_STEPS)
        assert on_target > 1000
        shares.append(flagged / on_target)
    assert all(0.1 < share < 0.4 for share in shares), shares
    assert abs(shares[0] - shares[1]) < 0.1, shares


def test_run_trace_follows_the_body_merges(runs):
    """Every cycle's tries in the host's order end at the program the run's
    merges took (checked inside `_tries`), and the stopping program is tried
    only where the FSM wanted it."""
    from frenetix_tpu_torch.utils.parting import _tries

    _, _, run_trace, _, _ = runs
    wanted = 0
    for c, cyc in enumerate(run_trace.cycles):
        assert [m["kind"] for m in cyc["merges"]] == ["mode", "mode", "stop"]
        tries, plan = _tries(run_trace, c)
        wanted += tries[0]["quintic"]
        assert plan["fsm_state"] is not None
    assert 0 < wanted < len(run_trace.cycles)


# ------------------------------------------------------- the classifier itself

# a stopping row from 12 m/s: 18 m in 3 s ends at rest without reversing,
# 10 m in 3 s overshoots and backs up (its velocity really turns negative)
_ROW = np.zeros(13)
_ROW[1], _ROW[3], _ROW[5] = 3.0, 12.0, 18.0
_FAR = _ROW.copy()
_FAR[1] = 2.0
_SHORT = _ROW.copy()
_SHORT[5] = 10.0
_FSM = {"state": np.array([4]), "desired_velocity": np.array([10.0]),
        "stop_s": np.array([90.0]), "stop_v": np.array([0.0])}


def _level(rows, best, selectable, cost, slots=None, s_vel=None, found=True):
    m = len(rows)
    return {"matrix": np.asarray(rows, float), "mask": np.ones(m, bool), "quintic": True,
            "best": best, "found": found, "selectable": np.asarray(selectable),
            "cost": np.asarray(cost, float),
            "slots": np.zeros((m, 11), bool) if slots is None else slots,
            "s_vel_min": np.zeros(m) if s_vel is None else np.asarray(s_vel, float)}


def _run_trace(level, fsm=_FSM):
    """A RunTrace of one cycle of one agent (id 7) that wants the stopping
    matrix and takes `level` from it: one regular level that found nothing,
    then the stopping program, each in the high-velocity mode."""
    from frenetix_tpu_torch.utils.parting import RunTrace

    m = len(level["mask"])

    def prog(group, quintic, found, lv=None):
        lv = lv or _level(np.tile(_FAR, (m, 1)), 0, [False] * m, [1.0] * m, found=False)
        p = {k: np.asarray(v)[None] for k, v in lv.items() if k not in ("quintic",)}
        p.update(low_vel=False, quintic=quintic, group=group, wanted=np.array([True]),
                 found=np.array([found]), best=np.array([lv["best"]]),
                 idx=np.array([lv["best"]]))
        return p

    tr = RunTrace(run_module=None)
    tr.cycles.append({
        "cycle": 0, "agent_ids": [7], "live": np.array([True]),
        "programs": [prog(0, False, False), prog(0, False, False),
                     prog("stop", True, level["found"], level),
                     prog("stop", True, level["found"], level)],
        "merges": [{"kind": "mode", "take": np.array([False])},
                   {"kind": "mode", "take": np.array([False])},
                   {"kind": "stop", "take": np.array([level["found"]])}],
        "source": np.array([2 if level["found"] else 0]),
        "fsm": {k: v.copy() for k, v in fsm.items()}})
    return tr


def _host_trace(level):
    """A CycleTrace of one plan call that tried the stopping matrix only."""
    from frenetix_tpu_torch.utils.parting import CycleTrace

    tr = CycleTrace(reactive=None)
    tr.plans.append({"desired_velocity": 10.0, "stop_point": (90.0, 0.0),
                     "fsm_state": "StopSign"})
    tr.levels.append(dict(level, plan=0))
    return tr


def _flip(slots_flipped, row, s_vel):
    """The device run selects candidate `row` (cost 1.0, selectable) at
    index 2 of [_ROW, its duplicate, row]; the host run, whose matrix drops
    the duplicate and pads, flags `row` at index 1 (`slots_flipped`, lowest
    velocity `s_vel`) and selects _ROW at index 0."""
    device = _level([_ROW, _ROW, row], 2, [True] * 3, [2.0, 2.0, 1.0])
    slots = np.zeros((3, 11), bool)
    slots[1, slots_flipped] = True
    host = _level([_ROW, row, np.zeros(13)], 0, [True, False, False], [2.0, 1.0, 0.0],
                  slots=slots, s_vel=[0.0, s_vel, 0.0])
    host["mask"] = np.array([True, True, False])
    return _run_trace(device), _host_trace(host)


def _classified(a, b):
    from frenetix_tpu_torch.utils.parting import classify_run_parting, first_run_parting

    hit = first_run_parting(a, b)
    assert hit == (0, 7)
    return classify_run_parting(a, b, *hit, dt=DT, n_steps=N_STEPS)


def test_classifier_matches_a_stopping_row_by_value_not_index():
    from frenetix_tpu_torch.utils.parting import first_run_parting

    row_b = _ROW.copy()
    row_b[5] = 17.0
    # the same candidate selected at index 2 on the device, 1 on the host
    device = _level([row_b, row_b, _ROW], 2, [True] * 3, [2.0, 2.0, 1.0])
    host = _level([row_b, _ROW, np.zeros(13)], 1, [True, True, False], [2.0, 1.0, 0.0])
    host["mask"] = np.array([True, True, False])
    assert first_run_parting(_run_trace(device), _host_trace(host)) is None
    # and another candidate at the device's index is a parting
    host["best"] = 2
    host["selectable"] = np.array([True, True, True])
    host["mask"][:] = True
    assert first_run_parting(_run_trace(device), _host_trace(host)) == (0, 7)


def test_classifier_accepts_a_threshold_flip_of_a_matched_stopping_row():
    row_b = _ROW.copy()
    row_b[5] = 17.0
    device = _level([row_b, row_b, _ROW], 2, [True] * 3, [2.0, 2.0, 1.0])
    slots = np.zeros((3, 11), bool)
    slots[1, [0, 2, 10]] = True
    host = _level([row_b, _ROW, np.zeros(13)], 0, [True, False, False], [2.0, 1.0, 0.0],
                  slots=slots, s_vel=[0.0, -2e-5, 0.0])
    host["mask"] = np.array([True, True, False])
    p = _classified(_run_trace(device), _host_trace(host))
    assert p.kind == "threshold", p.detail
    assert p.agent == 7 and p.plan == 0
    assert list(p.margins) == [2]            # the device's index of the flipped row
    assert abs(p.margins[2]["s_vel_f64"]) <= 1e-9


def test_classifier_rejects_a_real_negative_velocity():
    p = _classified(*_flip([0, 2, 10], _SHORT, -1.5))
    assert p.kind == "unexplained", p.detail


def test_classifier_rejects_a_curvature_flip():
    row = _ROW.copy()
    row[5] = 18.5
    p = _classified(*_flip([0, 5], row, 0.0))
    assert p.kind == "unexplained", p.detail


def test_classifier_rejects_a_differing_fsm_state():
    fsm = dict(_FSM, state=np.array([3]))            # PrepareStopSign
    level = _level([_ROW, _FAR], 0, [True, True], [1.0, 2.0])
    other = _level([_ROW, _FAR], 1, [True, True], [1.0, 1.0])
    p = _classified(_run_trace(level, fsm), _run_trace(other))
    assert p.kind == "unexplained" and "FSM" in p.detail, p.detail


@pytest.mark.parametrize("ulps, kind", [(2, "tie"), (5, "unexplained")])
def test_classifier_accepts_a_cost_tie_within_four_ulps_only(ulps, kind):
    gap = ulps * float(np.spacing(np.float32(100.0)))
    a = _level([_ROW, _FAR], 0, [True, True], [100.0, 100.0 + gap])
    b = _level([_ROW, _FAR], 1, [True, True], [100.0, 100.0 + gap])
    p = _classified(_run_trace(a), _run_trace(b))
    assert p.kind == kind, p.detail
