"""The port's float32 against the JAX package's float32 on the CPU:
`stop_sign` with the behavior planner on the host path, at its default size.

Both runs take 160 steps with the same statuses.  They part at one
cycle: plan call 10, the step 30 cycle, before the stop sign.  Up to it the
executed positions agree within 1e-4 m.  At that cycle the FSM's outputs
agree, and the two packages select different stopping candidates because
float32 rounding flips the negative-velocity test (`s_vel < -1e-5`) of a
candidate whose exact end velocity is 0 (`utils.parting`, "threshold").
The JAX float32 run is made once for the module.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_classified_parting, paired_runs, statuses

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return paired_runs("stop_sign", "float32", behavior=True, trace=True)


def test_stop_sign_float32_steps_and_statuses_match_jax(runs):
    jax_run, port_run = runs
    assert port_run["result"].steps == jax_run["result"].steps == 160
    assert statuses(port_run["result"]) == statuses(jax_run["result"])
    assert port_run["result"].success


def test_stop_sign_float32_rounding_rejects_stopping_candidates_in_both_packages(runs):
    """Of the stopping candidates whose exact end velocity is 0, float32
    flags a like share as reversing (`s_vel < -1e-5`) in JAX and in the
    port: the flip that parts the runs is the planner's, not the port's."""
    from frenetix_tpu_torch.utils.parting import stopping_flips

    shares = []
    for run in runs:
        flagged, on_target = stopping_flips(run["trace"], dt=0.1, n_steps=30)
        assert on_target > 1000
        shares.append(flagged / on_target)
    assert all(0.1 < share < 0.4 for share in shares), shares
    assert abs(shares[0] - shares[1]) < 0.1, shares


def test_stop_sign_float32_parts_from_jax_at_a_threshold_flip(runs):
    jax_run, port_run = runs
    parting = assert_classified_parting(jax_run, port_run, plan=10)
    level = parting.level
    jl, tl = jax_run["trace"].levels[level], port_run["trace"].levels[level]
    assert jl["quintic"] and tl["quintic"], "the parting cycle samples stopping"
    assert jl["best"] != tl["best"]


# ------------------------------------------------------- the classifier itself


def _trace(best, selectable, cost, slots=None, s_vel=None, quintic=False, matrix=None):
    from frenetix_tpu_torch.utils.parting import CycleTrace

    m = len(selectable)
    tr = CycleTrace(reactive=None)
    tr.plans.append({"desired_velocity": 10.0, "stop_point": None, "fsm_state": "S"})
    tr.levels.append({
        "plan": 0, "matrix": np.zeros((m, 13)) if matrix is None else matrix,
        "mask": np.ones(m, bool), "quintic": quintic, "best": best, "found": True,
        "selectable": np.asarray(selectable), "cost": np.asarray(cost, float),
        "slots": np.zeros((m, 11), bool) if slots is None else slots,
        "s_vel_min": np.zeros(m) if s_vel is None else np.asarray(s_vel, float)})
    return tr


def test_classifier_accepts_a_tie_within_four_ulps_only():
    from frenetix_tpu_torch.utils.parting import classify_parting, first_parting

    cost = np.array([100.0, 100.0 + 2 * float(np.spacing(np.float32(100.0))), 150.0])
    a, b = _trace(0, [True, True, True], cost), _trace(1, [True, True, True], cost)
    assert first_parting(a, b) == 0
    assert classify_parting(a, b, 0, dt=0.1, n_steps=30).kind == "tie"
    far = np.array([100.0, 100.01, 150.0])
    a, b = _trace(0, [True, True, True], far), _trace(1, [True, True, True], far)
    assert classify_parting(a, b, 0, dt=0.1, n_steps=30).kind == "unexplained"
    a, b = _trace(0, [True, True], [1.0, 2.0]), _trace(0, [True, True], [1.0, 2.0])
    assert first_parting(a, b) is None


def test_classifier_rejects_a_flip_of_another_mask_or_a_real_negative_velocity():
    from frenetix_tpu_torch.utils.parting import classify_parting

    # a stopping row from 12 m/s: 18 m in 3 s ends at rest without reversing,
    # 10 m in 3 s overshoots and backs up (its velocity really turns negative)
    row = np.zeros(13)
    row[1], row[3], row[5] = 3.0, 12.0, 18.0
    short = row.copy()
    short[5] = 10.0

    def parting(flipped_slots, matrix, s_vel):
        slots = np.zeros((2, 11), bool)
        slots[1, flipped_slots] = True
        a = _trace(1, [True, True], [2.0, 1.0], quintic=True, matrix=matrix)
        b = _trace(0, [True, False], [2.0, 1.0], slots=slots, s_vel=[0.0, s_vel],
                   quintic=True, matrix=matrix)
        return a, b, classify_parting(a, b, 0, dt=0.1, n_steps=30)

    _, _, p = parting([0, 2, 10], np.stack([row, row]), -2e-5)
    assert p.kind == "threshold", p.detail
    assert abs(p.margins[1]["s_vel_f64"]) <= 1e-9
    # a curvature flip (slot 5) is no velocity-sign threshold
    assert parting([0, 5], np.stack([row, row]), 0.0)[2].kind == "unexplained"
    # a velocity that is negative in exact arithmetic is no rounding
    _, _, p = parting([0, 2, 10], np.stack([short, short]), -1.5)
    assert p.kind == "unexplained", p.detail
    # a flagged value far beyond float32 rounding is not either
    assert parting([0, 2, 10], np.stack([row, row]), -0.5)[2].kind == "unexplained"
    # a differing FSM state is never float32 rounding of the cycle
    a, b, _ = parting([0, 2, 10], np.stack([row, row]), -2e-5)
    b.plans[0]["fsm_state"] = "T"
    assert "FSM" in classify_parting(a, b, 0, dt=0.1, n_steps=30).detail
