"""The occlusion module inside the port's device-resident run, against the
port's own host sequential run (held against the JAX package to 1e-9 m in
`test_torch_occlusion.py`), at float64 on the CPU:

- the blind spot (the parked truck 45 m down the road, so that the gate acts
  within three cycles) with the module, occ_um 2.0, occ_ve 0.5 and the
  visible-area stage: the host's gate removes a first choice, and the run
  follows it;
- phantoms capped by the free slots of the NOMINAL width (max_obstacles 3,
  the truck and a peer): the run's buffers hold one window slot, and it
  still admits the one phantom the host writes.

Equal statuses and steps, positions and velocities within 1e-9 m.
"""
import torch

from frenetix_tpu_torch.io import commonroad as tcr, scenario_factory as tfactory
from frenetix_tpu_torch.occlusion import OcclusionModule
from frenetix_tpu_torch.utils.config import FrenetixConfig

from torch_parity import (assert_run_equals_host, blind_spot, device_and_host,
                          post_pass_config)

torch.set_num_threads(1)


def near_truck():
    return blind_spot(tfactory, tcr, truck_x=45.0)


def test_blind_spot_with_the_occlusion_module_matches_sequential_host():
    cfg = post_pass_config(FrenetixConfig, module=True, vis=True)
    ds, dres, host, hres = device_and_host(near_truck, cfg, 9)
    assert ds.use_occlusion and ds.use_occ_geom and ds.use_vis_occl
    assert sum(a.planner.gate_stats["changed"] for a in host.agents) > 0
    assert_run_equals_host(dres, hres)


def test_phantoms_capped_by_free_slots_of_the_nominal_width(monkeypatch):
    written = []
    augment = OcclusionModule.augment_predictions

    def counting(self, *args, **kwargs):
        pd, n = augment(self, *args, **kwargs)
        written.append((len(self._last_phantoms), n))
        return pd, n

    monkeypatch.setattr(OcclusionModule, "augment_predictions", counting)
    cfg = post_pass_config(FrenetixConfig, module=True, soft=False, max_obstacles=3)
    ds, dres, _, hres = device_and_host(near_truck, cfg, 6)
    assert ds._runner.g.pred_windows["valid"].shape[-2] == 1
    assert_run_equals_host(dres, hres)
    # the host found the truck's two spawn points and had room for one
    assert (2, 1) in written
