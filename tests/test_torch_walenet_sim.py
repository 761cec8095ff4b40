"""Wale-Net simulations of the port against the JAX package, float64 on the CPU.

Both packages read the same synthetic export (narrow widths; the real
weights are not in the repository) and run their nets in float32, as they
do on any device.  The JAX raster takes its NumPy route (the port has no
native rasterizer).

- Host loop, JAX against the port: the single-agent highway with its lead
  vehicle predicted by the net, and the two-agent highway
  (`start_multiagent`: each agent's net reads the other's executed
  history), sequential and batched.  Equal statuses and steps; executed
  positions and velocities within POS_TOL = 1e-9 m.  Where that tolerance
  comes from: the two float32 nets agree to ~1e-6 of their outputs
  (tests/test_torch_walenet.py holds them to 1e-4), which moves a predicted
  mean by micrometres; that moves no selection at these scenarios' cost
  gaps, and with equal selections the executed states are the same float64
  arithmetic on both sides (round-off ~1e-13 m over a run).  A selection
  that flipped on a float32 tie would show here as a gap of metres.
- The port's device-resident run on its hybrid-prediction path against the
  port's host batched run: the single-agent overtake (a scenario obstacle
  predicted each cycle) and the two-agent highway, alone and with the
  behavior planner (its host FSM on the same mirrors), equal statuses and
  steps, positions within 1e-6 m; one carry fetch per cycle plus the final
  one.
- A walenet fleet runs its members one after another, each equal to its
  solo run.

Scenarios are shortened (`n_steps`) and sampled at level 1
(`coarse_sampling`), so that the file stays inside its time budget.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu import native
from frenetix_tpu.io import scenario_factory as jfactory
from frenetix_tpu.models import walenet as jw
from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.models import walenet as tw
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import FrenetixConfig
from frenetix_tpu_torch.workloads import write_synthetic_walenet_onnx
from torch_parity import CPU, coarse_sampling, host_count

torch.set_num_threads(1)

POS_TOL = 1e-9
DEVICE_TOL = 1e-6
WIDTHS = dict(conv1=4, conv2=3, embed=4, enc=6, nbr_feat=5, scene_feat=3, dec=7)
N_STEPS = 50


@pytest.fixture(scope="module", autouse=True)
def synthetic_net(tmp_path_factory):
    """Both packages on one synthetic export; every cache cleared before and
    after the module."""
    path = write_synthetic_walenet_onnx(
        str(tmp_path_factory.mktemp("walenet") / "synthetic.onnx"), seed=4, **WIDTHS)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "load", lambda: None)
    mp.setattr(jw, "WALENET_ONNX_PATH", path)
    mp.setattr(tw, "WALENET_ONNX_PATH", path)
    caches = (jw._WALENET_CACHE, jw.WaleNet._jit_cache, tw._WALENET_CACHE,
              tw.WaleNet._net_cache)
    for c in caches:
        c.clear()
    yield path
    for c in caches:
        c.clear()
    mp.undo()


def _cfg(cls, multi=False, batched=False, behavior=False):
    cfg = coarse_sampling(cls(dtype="float64"))
    cfg.prediction.mode = "walenet"
    cfg.simulation.start_multiagent = multi
    cfg.simulation.batched_device_agents = batched
    cfg.behavior.use_behavior_planner = behavior
    return cfg


def _states(res):
    return {aid: np.array([[*s.position, s.velocity] for s in hist])
            for aid, hist in res.histories.items()}


CASES = {"highway": (False, False), "highway2_sequential": (True, False),
         "highway2_batched": (True, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_host_run_matches_jax(case):
    multi, batched = CASES[case]
    jres = JaxSimulation(jfactory.make_highway(n_steps=N_STEPS),
                         _cfg(JaxConfig, multi, batched)).run()
    sim = Simulation(tfactory.make_highway(n_steps=N_STEPS),
                     _cfg(FrenetixConfig, multi, batched), CPU)
    assert len(sim.agents) == (2 if multi else 1)
    res = sim.run()
    assert res.steps == jres.steps
    assert ({k: v.name for k, v in res.agent_status.items()}
            == {k: v.name for k, v in jres.agent_status.items()})
    want, got = _states(jres), _states(res)
    for aid in want:
        assert got[aid].shape == want[aid].shape, aid
        np.testing.assert_allclose(got[aid], want[aid], rtol=0, atol=POS_TOL,
                                   err_msg=str(aid))
    # the net predicted the lead (single agent) or the peer (two agents)
    assert tw._WALENET_CACHE and next(iter(tw._WALENET_CACHE.values())).scenario \
        is sim.scenario


def _device_against_host_batched(make, multi, behavior=False):
    sim = Simulation(make(), _cfg(FrenetixConfig, multi, behavior=behavior), CPU)
    ds = tds.DeviceSimulation(sim)
    assert ds.hybrid_pred and not ds.fsm_in_scan
    fetches = host_count("device_sim.fetches")
    dres = ds.run()
    assert host_count("device_sim.fetches") - fetches == ds.n_cycles + 1 == dres.extras["fetches"]
    host = Simulation(make(), _cfg(FrenetixConfig, multi, True, behavior), CPU).run()
    assert dres.steps == host.steps
    assert [int(s) for s in dres.status] == [int(host.agent_status[a])
                                            for a in dres.agent_ids]
    for col, aid in enumerate(dres.agent_ids):
        pos = np.array([s.position for s in host.histories[aid][1:]])
        np.testing.assert_allclose(dres.trajectories[:len(pos), col, :2], pos,
                                   rtol=0, atol=DEVICE_TOL, err_msg=str(aid))
    return ds, dres, host


@pytest.mark.parametrize("family,multi,behavior", [
    ("overtake", False, False), ("highway", True, False), ("highway", True, True)])
def test_device_hybrid_run_matches_host_batched(family, multi, behavior):
    make = lambda: getattr(tfactory, f"make_{family}")(n_steps=N_STEPS)  # noqa: E731
    ds, dres, host = _device_against_host_batched(make, multi, behavior)
    assert len(ds.agents) == (2 if multi else 1)
    assert dres.extras["k1_launches"] == 0          # the CPU runs K1's plain twin
    # the adapter to the host result shape keeps the executed histories
    as_host = ds.to_simulation_result(dres)
    for aid, hist in host.histories.items():
        assert len(as_host.histories[aid]) == len(hist)


def test_walenet_fleet_runs_members_one_after_another():
    makes = [lambda: tfactory.make_highway(n_steps=40, lead_gap=35.0),
             lambda: tfactory.make_overtake(n_steps=40)]
    sims = [tds.DeviceSimulation(Simulation(m(), _cfg(FrenetixConfig), CPU))
            for m in makes]
    fetches = host_count("device_sim.fetches")
    results = tds.run_fleet(sims)
    assert host_count("device_sim.fetches") - fetches == sum(s.n_cycles + 1 for s in sims)
    for make, res in zip(makes, results):
        solo = tds.DeviceSimulation(Simulation(make(), _cfg(FrenetixConfig), CPU)).run()
        assert res.extras["fleet_size"] == 2
        assert res.steps == solo.steps
        np.testing.assert_array_equal(res.status, solo.status)
        np.testing.assert_array_equal(res.trajectories, solo.trajectories)
