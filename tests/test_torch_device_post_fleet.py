"""The post-passes in fleets of the port's device-resident run, at float64
on the CPU:

- a fleet of two members on different maps (the blind spot and a left turn,
  of different lengths) with the occlusion module and the sensor stage:
  each member equals its solo run bit for bit, so the padding of road walls
  and spawn tensors is inert;
- members that differ in the responsibility weight or the occlusion
  settings raise ValueError, as in the JAX package.
"""
import pytest
import torch

from frenetix_tpu_torch.io import commonroad as tcr, scenario_factory as tfactory
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import FrenetixConfig
from torch_parity import CPU, assert_equal_runs, blind_spot, host_count, post_pass_config

torch.set_num_threads(1)

def fleet_members():
    """The blind spot (6 steps) and a left turn (3 steps) with the occlusion
    module and the sensor stage, each as a fresh DeviceSimulation (the
    padded lanelets of the responsibility term are held in
    `test_torch_device_post_parts.py`: on the CPU their reach grids cost
    minutes here)."""
    out = []
    for make, steps in ((lambda: blind_spot(tfactory, tcr, truck_x=45.0), 6),
                        (lambda: tfactory.make_turn_left(n_steps=120), 3)):
        cfg = post_pass_config(FrenetixConfig, module=True, vis=True)
        cfg.occlusion.max_phantoms = 1        # a cheaper risk stack on the CPU
        sim = Simulation(make(), cfg, CPU)
        sim.max_steps = steps
        out.append(tds.DeviceSimulation(sim))
    return out


def test_fleet_with_post_passes_equals_solo_runs():
    members = fleet_members()
    g0, g1 = (m.tensors for m in members)
    # different maps: the padding of the walls and spawn tensors is exercised
    assert g0.road_segs.shape != g1.road_segs.shape
    assert g0.occ_obst.shape != g1.occ_obst.shape
    assert members[0].n_cycles != members[1].n_cycles
    fetches = host_count("device_sim.fetches")
    fleet = tds.run_fleet(members)
    assert host_count("device_sim.fetches") == fetches + 1
    for i, (a, b) in enumerate(zip(fleet, (m.run() for m in fleet_members()))):
        assert_equal_runs(a, b, f"member {i}", atol=0.0)


@pytest.mark.parametrize("change", ["responsibility", "occlusion"])
def test_fleet_members_must_share_the_post_pass_settings(change):
    def member(second):
        cfg = post_pass_config(FrenetixConfig, resp=0.2, module=True)
        if second and change == "responsibility":
            cfg.cost_weights["responsibility"] = 0.5
        if second and change == "occlusion":
            cfg.occlusion.harm_threshold = 0.05
        return tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=30), cfg,
                                               CPU))

    with pytest.raises(ValueError, match="responsibility weight"):
        tds.run_fleet([member(False), member(True)])
