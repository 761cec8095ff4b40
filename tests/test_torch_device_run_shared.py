"""One captured device-resident run serving several scenarios
(`parallel.device_sim.share_runner`), and the run's spans and counters
(`utils.tracing`), on the CPU at a small size:

- runs on a shared runner, in the order A, B, A, B, each equal bitwise to
  a fresh `DeviceSimulation(sim).run()` of the same scenario;
- a runner is not shared across unequal statics or shapes;
- with tracing on, a run is the spans `frenetix.device_sim.load`, `.reset`,
  `.replay`, `.fetch`, `.finalize` and `.cycles`, and counts its cycles and
  its one fetch; a runner captures again after a switch of tracing;
- the one fetch carries each cycle's chosen cost.

The card's case (shared and fresh replayed runs bitwise, no capture after
the first, `sync_debug` with tracing on) carries the `cuda` marker.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, share_runner
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import tracing
from frenetix_tpu_torch.utils.compiled import _Graph
from frenetix_tpu_torch.utils.config import load_config

from torch_parity import host_count

FIELDS = ("status", "trajectories", "status_per_step", "selections", "found", "costs")
CONVOYS = ((10.0, 30.0), (9.4, 33.5))      # (ego speed, gap) of scenarios A and B


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _convoy(device, ego_v, gap, sampling=(1, 2), n_steps=40, max_steps=12):
    """A three-agent convoy (four cycles), planned at the first level."""
    cfg = load_config()
    cfg.simulation.start_multiagent = True
    cfg.planning.sampling_min, cfg.planning.sampling_max = sampling
    scenario = scenario_factory.make_convoy(n_vehicles=2, ego_v=ego_v, gap=gap,
                                            n_steps=n_steps)
    sim = Simulation(scenario, cfg, device)
    sim.max_steps = max_steps
    return DeviceSimulation(sim)


def _assert_same(got, want):
    for name in FIELDS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.extras["x_cl_cycles"], want.extras["x_cl_cycles"])


def _shared_against_fresh(device):
    sims = [_convoy(device, *c) for c in CONVOYS]
    share_runner(sims)
    assert sims[0]._runner is sims[1]._runner
    fresh = [_convoy(device, *c).run() for c in CONVOYS]
    for i in (0, 1, 0, 1):
        _assert_same(sims[i].run(), fresh[i])
    return sims, fresh


def test_a_shared_runner_gives_each_scenario_its_fresh_result():
    sims, fresh = _shared_against_fresh(torch.device("cpu"))
    assert not np.array_equal(fresh[0].trajectories, fresh[1].trajectories)


@pytest.mark.parametrize("other", [
    dict(sampling=(2, 3)),              # other statics: the sampling level
    dict(max_steps=15),                 # another number of cycles
])
def test_share_runner_refuses_unequal_statics_or_shapes(other):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="shared runner"):
        share_runner([_convoy(cpu, *CONVOYS[0]), _convoy(cpu, *CONVOYS[1], **other)])


def test_a_run_is_traced_in_spans_and_counters():
    cpu = torch.device("cpu")
    sims = [_convoy(cpu, *c) for c in CONVOYS]
    share_runner(sims)
    sims[0].run()
    with tracing.on():
        tracing.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sims[1].run()
        snap = tracing.snapshot()
    names = {ev.name for ev in prof.events()}
    for part in ("load", "reset", "replay", "cycles", "fetch", "finalize"):
        assert f"frenetix.device_sim.{part}" in names, part
    assert "frenetix.device_sim.capture" not in names      # the CPU captures nothing
    assert snap["counters"]["device_sim.cycles"] == sims[1].n_cycles
    assert snap["counters"]["device_sim.fetches"] == 1
    assert "device_sim.captures" not in snap["counters"]


def test_a_switch_of_tracing_makes_the_runner_capture_again():
    ds = _convoy(torch.device("cpu"), *CONVOYS[0])
    ds.run()
    runner = ds._runner
    assert runner.graph is None                         # the CPU captured nothing
    # as after a capture with tracing off
    runner.graph = _Graph.__new__(_Graph)
    runner.graph.traced = False
    assert not runner.graph.stale
    with tracing.on():
        assert runner.graph.stale
    assert not runner.graph.stale


def test_the_fetch_carries_each_cycles_chosen_cost():
    res = _convoy(torch.device("cpu"), *CONVOYS[0]).run()
    assert res.costs.shape == res.found.shape
    assert np.all(np.isfinite(res.costs)) and np.all(res.costs > 0.0)


@pytest.mark.cuda
def test_a_shared_runner_on_the_card_captures_once_and_matches_fresh_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    before = host_count("device_sim.captures")
    sims, _ = _shared_against_fresh(card)
    # one capture for the shared runner, one per fresh run
    assert tracing.COUNTERS["device_sim.captures"] - before == 1 + len(CONVOYS)
    with tracing.on():
        _assert_same(sims[1].run(sync_debug=True), sims[1].run())
    # the switch made the shared runner capture again, once
    assert tracing.COUNTERS["device_sim.captures"] - before == 2 + len(CONVOYS)
    assert host_count("device_sim.fetches") > 0
