"""The responsibility term and the visible-area sensor stage inside the
port's device-resident run, against the port's own host sequential run
(which `test_torch_responsibility.py` and `test_torch_occlusion.py` hold
against the JAX package to 1e-9 m):

- highway with two agents and the responsibility term 0.2: the reach grids
  are rasterized on the device from the cycle's rows, peers included, and
  the run's buffers hold one window slot of the nominal three;
- the blind spot with the visible-area stage alone;
- the traffic light (the short variant of `test_torch_device_fsm.py`) with
  the behavior planner and the responsibility term: the in-run FSM, the
  forced hybrid path and the host sequential loop agree.

At float64 on the CPU both sides run the same operations on the same
inputs; what differs is the order of the obstacle rows (the run appends
peers, the host fills free slots).  Equal statuses and steps, positions and
velocities within 1e-9 m.  Short runs (`sim.max_steps`) at level-1 sampling:
a cycle with the risk stack takes seconds on one CPU thread.  The occlusion
module is in `test_torch_device_post_occlusion.py`, fleets in
`test_torch_device_post_fleet.py`.
"""
import torch

from frenetix_tpu_torch.io import commonroad as tcr, scenario_factory as tfactory
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import FrenetixConfig

from torch_parity import (CPU, assert_equal_runs, assert_run_equals_host, blind_spot,
                          device_and_host, host_count, post_pass_config)

torch.set_num_threads(1)


def test_responsibility_highway_two_agents_matches_sequential_host():
    cfg = post_pass_config(FrenetixConfig, resp=0.2, max_obstacles=3)
    ds, dres, _, hres = device_and_host(lambda: tfactory.make_highway(n_steps=60), cfg, 12)
    assert len(ds.agents) == 2 and ds.resp_weight == 0.2 and ds.need_risks
    # the one lead vehicle is an agent: no window slot is ever filled, and
    # the run keeps one
    assert ds.tensors.pred_windows["valid"].shape[-2] == 3
    assert ds._runner.g.pred_windows["valid"].shape[-2] == 1
    assert_run_equals_host(dres, hres)
    assert dres.found[1:].all()


def test_visible_area_stage_alone_matches_sequential_host():
    cfg = post_pass_config(FrenetixConfig, vis=True)
    ds, dres, _, hres = device_and_host(lambda: blind_spot(tfactory, tcr), cfg, 45)
    assert ds.use_vis_occl and not ds.use_occlusion and not ds.need_risks
    assert ds.tensors.road_segs.shape[-2:] == (2, 2)
    assert_run_equals_host(dres, hres)


LIGHT = dict(length=110.0, stop_at=50.0, red_steps=80, n_steps=150)


def behavior_sim(device_fsm, steps=30):
    cfg = post_pass_config(FrenetixConfig, resp=0.2, max_obstacles=1, multi=False)
    cfg.behavior.use_behavior_planner = True
    cfg.behavior.device_fsm = device_fsm
    sim = Simulation(tfactory.make_traffic_light(**LIGHT), cfg, CPU)
    sim.max_steps = steps
    return sim


def test_behavior_with_responsibility_in_the_run_equals_hybrid_and_host():
    ds = tds.DeviceSimulation(behavior_sim("auto"))
    assert ds.fsm_in_scan and ds.resp_weight == 0.2, ds.fsm_reason
    fetches = host_count("device_sim.fetches")
    in_run = ds.run()
    assert host_count("device_sim.fetches") == fetches + 1 and not in_run.extras.get("bailed")
    hybrid_ds = tds.DeviceSimulation(behavior_sim("hybrid"))
    assert not hybrid_ds.fsm_in_scan
    hybrid = hybrid_ds.run()
    assert hybrid.extras["fetches"] == hybrid_ds.n_cycles + 1
    assert_equal_runs(hybrid, in_run, "hybrid vs in-run FSM")
    assert_run_equals_host(in_run, behavior_sim("auto").run())
    # the light is red: the ego slows toward the line
    assert in_run.trajectories[in_run.steps - 1, 0, 3] < 9.0
