"""The port's float32 against the JAX package's float32 on the CPU:
`traffic_light` with the behavior planner on the host path, at its default size.

Both runs take 151 steps with the same statuses.  They part at one
cycle: plan call 7, the step 21 cycle, before the red light.  Up to it the
executed positions agree within 1e-4 m.  At that cycle the FSM's outputs
agree, and the two packages select different stopping candidates because
float32 rounding flips the negative-velocity test (`s_vel < -1e-5`) of a
candidate whose exact end velocity is 0 (`utils.parting`, "threshold").
The JAX float32 run is made once for the module.
"""
import pytest
import torch

from torch_parity import assert_classified_parting, paired_runs, statuses

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return paired_runs("traffic_light", "float32", behavior=True, trace=True)


def test_traffic_light_float32_steps_and_statuses_match_jax(runs):
    jax_run, port_run = runs
    assert port_run["result"].steps == jax_run["result"].steps == 151
    assert statuses(port_run["result"]) == statuses(jax_run["result"])
    assert port_run["result"].success


def test_traffic_light_float32_rounding_rejects_stopping_candidates_in_both_packages(runs):
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


def test_traffic_light_float32_parts_from_jax_at_a_threshold_flip(runs):
    jax_run, port_run = runs
    parting = assert_classified_parting(jax_run, port_run, plan=7)
    level = parting.level
    jl, tl = jax_run["trace"].levels[level], port_run["trace"].levels[level]
    assert jl["quintic"] and tl["quintic"], "the parting cycle samples stopping"
    assert jl["best"] != tl["best"]
