"""One captured run for several fleets, lasting across their runs
(`parallel.device_sim.FleetRunner`), on the CPU in float64 at a small size:

- two fleets of the four families (highway, two-agent overtake, curve,
  three-agent convoy) alternated through one runner, sized to the maxima
  over both, each member bitwise equal to its solo run (`run_fleet(chunk=)`,
  whose chunks go through a `FleetRunner`, is held to the unchunked fleet
  in `test_torch_fleet.py`);
- the fleet's counters: members, real and stacked agent-cycles, and the
  load span only when the buffers change owner;
- a fleet the runner was not made for refused;
- single scenarios on `share_runner` still equal their fresh runs bitwise.

The card's case (float32, replayed: the fleets alternated through one
runner capture once and equal every member's solo replayed run bitwise)
carries the `cuda` marker:
`python -m pytest tests/test_torch_fleet_runner.py -m cuda --noconftest -q`.

Scenarios are shortened and sampled at level 1 to stay inside the budget.
"""
import contextlib

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory as factory
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig
from frenetix_tpu_torch.utils import tracing
from torch_parity import CPU, coarse_sampling, host_count

torch.set_num_threads(1)

FIELDS = ("status", "trajectories", "status_per_step", "selections", "found", "costs")


def _cfg(multi: bool, dtype: str):
    cfg = coarse_sampling(tconfig.load_config())
    cfg.dtype = dtype
    cfg.simulation.start_multiagent = multi
    return cfg


def _member(family: int, speed: float, n_steps: int, device=CPU, dtype="float64"):
    """Family `family` of highway, overtake, curve and convoy, sped up by
    `speed`, recorded for `n_steps`."""
    if family == 0:
        scenario = factory.make_highway(ego_v=15.0 * speed, n_steps=n_steps)
    elif family == 1:
        scenario = factory.make_overtake(ego_v=14.0 * speed, n_steps=n_steps)
    elif family == 2:
        scenario = factory.make_curve(ego_v=12.0 * speed, n_steps=n_steps)
    else:
        scenario = factory.make_convoy(n_vehicles=2, ego_v=10.0 * speed, n_steps=n_steps)
    multi = family in (1, 3)
    return tds.DeviceSimulation(Simulation(scenario, _cfg(multi, dtype), device))


def _fleet(speed: float, n_steps: int, device=CPU, dtype="float64"):
    """The four families, sped up by `speed`, recorded for `n_steps`."""
    return [_member(k, speed, n_steps, device, dtype) for k in range(4)]


FLEETS = ((1.0, 24), (0.93, 30))       # (speed factor, recorded steps) of fleets A and B


def _assert_same(got, want):
    for name in FIELDS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.steps == want.steps
    assert np.array_equal(got.extras["x_cl_cycles"], want.extras["x_cl_cycles"])


@pytest.fixture(scope="module")
def shared():
    """Fleets A and B on one runner in the order A, B, A, B, with the
    counters of each run."""
    tracing.disable()
    fleets = [_fleet(*f) for f in FLEETS]
    runner = tds.FleetRunner(fleets)
    runs = []
    for i in (0, 1, 0, 1):
        tracing.reset()
        with _spans() as spans:
            results = runner.run(fleets[i])
        snap = tracing.snapshot()
        snap["host_spans"] = spans
        runs.append((i, results, snap))
    tracing.reset()
    return fleets, runner, runs


@contextlib.contextmanager
def _spans():
    """The names of the host spans opened inside the block."""
    names, real = [], tracing.span

    def spy(name):
        names.append(name)
        return real(name)

    tracing.span = spy
    try:
        yield names
    finally:
        tracing.span = real


def test_the_runner_is_sized_to_both_fleets(shared):
    fleets, runner, _ = shared
    assert runner.size == 4
    assert runner.dims["a"] == 3
    assert runner.dims["c"] == max(s.n_cycles for f in fleets for s in f)
    assert fleets[0][0].n_cycles < fleets[1][0].n_cycles


@pytest.mark.parametrize("member", range(4))
def test_a_shared_fleet_member_equals_its_solo_run(shared, member):
    _, _, runs = shared
    for fleet in (0, 1):
        solo = _member(member, *FLEETS[fleet]).run()
        got = next(results for i, results, _ in runs if i == fleet)[member]
        _assert_same(got, solo)


def test_a_fleet_run_counts_its_members_and_agent_cycles(shared):
    fleets, runner, runs = shared
    for k, (i, _, snap) in enumerate(runs):
        counters = snap["counters"]
        assert counters["device_sim.fleet.members"] == 4
        real = sum(len(s.agents) * s.n_cycles for s in fleets[i])
        assert counters["device_sim.fleet.agent_cycles_real"] == real
        assert counters["device_sim.fleet.agent_cycles_stacked"] == \
            4 * runner.dims["a"] * runner.dims["c"]
        assert counters["device_sim.cycles"] == runner.dims["c"]
        # the runner is made holding fleet A; every later run changes the
        # buffers' owner, so it loads
        assert snap["host_spans"].count("frenetix.device_sim.fleet.load") == (k > 0)
        assert "frenetix.device_sim.load" not in snap["host_spans"]


def test_a_fleet_whose_inputs_the_buffers_hold_loads_nothing(shared):
    fleets, runner, runs = shared
    with _spans() as spans:
        again = runner.run(fleets[1])
    assert "frenetix.device_sim.fleet.load" not in spans
    for got, want in zip(again, runs[-1][1]):
        _assert_same(got, want)


def test_a_run_pads_and_stacks_nothing(shared, monkeypatch):
    """The fleets were stacked when the runner was made: a run only copies."""
    fleets, runner, runs = shared

    def refused(*args, **kwargs):
        raise AssertionError("a fleet stacked again")

    monkeypatch.setattr(tds, "_fleet_stack", refused)
    monkeypatch.setattr(tds.DeviceSimulation, "_padded_tensors", refused)
    for i in (0, 1):
        for got, want in zip(runner.run(fleets[i]), runs[i][1]):
            _assert_same(got, want)


@pytest.mark.parametrize("other", ["larger", "outsider", "reordered"])
def test_a_fleet_the_runner_was_not_made_for_is_refused(shared, other):
    """Its stack was never made: a fleet with one member too many, with a
    member from outside the runner's fleets, or in another order."""
    fleets, runner, _ = shared
    fleet = {"larger": lambda: fleets[0] + fleets[1][:1],
             "outsider": lambda: fleets[0][:3] + [_member(3, *FLEETS[0])],
             "reordered": lambda: fleets[0][::-1]}[other]()
    with pytest.raises(ValueError, match="only the fleets it was made for"):
        runner.run(fleet)


def test_share_runner_still_gives_single_scenarios_their_fresh_runs():
    def convoy(gap):
        return tds.DeviceSimulation(Simulation(
            factory.make_convoy(n_vehicles=2, gap=gap, n_steps=24), _cfg(True, "float64"),
            CPU))

    sims = [convoy(30.0), convoy(33.5)]
    tds.share_runner(sims)
    fresh = [convoy(30.0).run(), convoy(33.5).run()]
    for i in (0, 1, 0):
        _assert_same(sims[i].run(), fresh[i])


@pytest.mark.cuda
def test_on_the_card_one_capture_serves_both_fleets_and_each_member_is_its_solo_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    fleets = [_fleet(*f, device=card, dtype="float32") for f in FLEETS]
    runner = tds.FleetRunner(fleets)
    before = host_count("device_sim.captures")
    runs = [(i, runner.run(fleets[i])) for i in (0, 1, 0, 1)]
    assert host_count("device_sim.captures") - before == 1
    assert all(r.extras["graph"] for _, results in runs for r in results)
    for i, results in runs:
        for k, got in enumerate(results):
            _assert_same(got, _member(k, *FLEETS[i], device=card, dtype="float32").run())
