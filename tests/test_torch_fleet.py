"""Scenario fleets of the port's device-resident run
(`frenetix_tpu_torch.parallel.device_sim.run_fleet`).

A fleet pads every member to the fleet's maxima with inert rows and runs the
same body over a leading scenario axis.  Three different members (highway,
two-agent overtake, curve: other agent counts, reference lengths, horizons,
goal geometry) must equal their solo runs in status and steps, and in
trajectories within 1e-9 (float64; every op reduces over trailing axes only,
so a member's slice sees the same operations, and only padded obstacle rows
join its sums as exact zeros).  Chunked equals unchunked, mismatched statics
raise, and `workloads.device_fleet` gives members that differ.

Scenarios are shortened and sampled at level 1 to stay inside the budget.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch import workloads
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig
from torch_parity import CPU, coarse_sampling, host_count

torch.set_num_threads(1)

ATOL = 1e-9


def _tcfg(**overrides):
    cfg = tconfig.load_config(overrides=overrides, strict_overrides=True)
    cfg.dtype = "float64"
    return coarse_sampling(cfg)


def _members():
    multi = _tcfg(simulation={"start_multiagent": True})
    return [
        tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=100), _tcfg(),
                                        CPU)),
        tds.DeviceSimulation(Simulation(tfactory.make_overtake(n_steps=150), multi,
                                        CPU)),
        tds.DeviceSimulation(Simulation(tfactory.make_curve(n_steps=110), _tcfg(), CPU)),
    ]


@pytest.fixture(scope="module")
def fleet_and_solo():
    fetches = host_count("device_sim.fetches")
    fleet = tds.run_fleet(_members())
    assert host_count("device_sim.fetches") == fetches + 1      # ONE fetch for the whole fleet
    return fleet, [s.run() for s in _members()]


def _assert_same(got, want):
    np.testing.assert_array_equal(got.status, want.status)
    assert got.steps == want.steps
    np.testing.assert_array_equal(got.found, want.found)
    np.testing.assert_array_equal(got.status_per_step, want.status_per_step)
    np.testing.assert_allclose(got.trajectories, want.trajectories, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.selections, want.selections, rtol=0, atol=ATOL)


@pytest.mark.parametrize("member", [0, 1, 2])
def test_fleet_member_equals_its_solo_run(fleet_and_solo, member):
    fleet, solo = fleet_and_solo
    _assert_same(fleet[member], solo[member])
    assert fleet[member].extras["fleet_size"] == 3
    assert fleet[member].trajectories.shape == solo[member].trajectories.shape


def test_fleet_members_differ_in_size_and_outcome(fleet_and_solo):
    """The padding is exercised: agent counts, cycles and step counts differ,
    and the members reach their goals."""
    fleet, _ = fleet_and_solo
    sims = _members()
    assert [len(s.agents) for s in sims] == [1, 2, 1]
    assert len({s.n_cycles for s in sims}) == 3
    assert len({int(s.tensors.ref.s.shape[1]) for s in sims}) > 1
    assert len({r.steps for r in fleet}) == 3
    for r in fleet:
        assert (r.status == 2).all(), r.status          # COMPLETED_SUCCESS


def test_chunked_fleet_equals_unchunked(fleet_and_solo):
    """chunk = 2: two runs through the same buffers, the second filled with a
    repeat of its first member; one fetch per group."""
    fleet, _ = fleet_and_solo
    fetches = host_count("device_sim.fetches")
    chunked = tds.run_fleet(_members(), chunk=2)
    assert host_count("device_sim.fetches") == fetches + 2
    assert len(chunked) == 3
    for got, want in zip(chunked, fleet):
        _assert_same(got, want)
        assert got.extras["fleet_size"] == 3


def test_fleet_of_one_equals_solo(fleet_and_solo):
    _, solo = fleet_and_solo
    (got,) = tds.run_fleet(_members()[:1])
    _assert_same(got, solo[0])


def test_padded_tensors_are_inert_rows():
    sims = _members()
    dims = tds._fleet_dims(sims)
    assert dims["a"] == 2 and dims["c"] == max(s.n_cycles for s in sims)
    padded = sims[0]._padded_tensors(dims)
    assert padded.active0.tolist() == [True, False]
    assert padded.x_cl0.shape == (2, 6) and padded.g_rings.shape[:2] == (2, dims["g"])
    assert padded.pred_windows["means"].shape[0] == dims["c"]
    assert padded.obst_poses.shape[:2] == (dims["t1"], dims["o"])
    assert padded.ref.s.shape == (2, dims["r"])
    # the path length goes on with its last step; other tables repeat a row
    steps = np.diff(padded.ref.s[0])
    np.testing.assert_allclose(steps, steps[0], rtol=1e-9)
    stacked = tds._fleet_stack(sims, dims)
    assert stacked.x_cl0.shape == (3, 2, 6) and stacked.max_steps.shape == (3,)
    assert stacked.max_steps.tolist() == [s.max_steps for s in sims]


def test_padded_goal_ring_keeps_its_inside():
    """A ring padded to more vertices (the last one repeated) contains the
    same points."""
    sim = _members()[0]
    dims = dict(tds._fleet_dims([sim]), e=sim.tensors.g_rings.shape[2] + 3, g=2)
    g_pad = sim._padded_tensors(dims).to(CPU, torch.float64)
    g = sim.tensors.to(CPU, torch.float64)
    ring = sim.tensors.g_rings[0, 0]
    rng = np.random.default_rng(3)
    pts = rng.uniform(ring.min(axis=0) - 2.0, ring.max(axis=0) + 2.0, size=(300, 2))
    vel = torch.full((1,), 5.0, dtype=torch.float64)
    inside = [bool(tds.goal_check(g, torch.as_tensor(p)[None], vel)[0]) for p in pts]
    inside_pad = [bool(tds.goal_check(g_pad, torch.as_tensor(p)[None], vel)[0])
                  for p in pts]
    assert inside == inside_pad and 30 < sum(inside) < 270


@pytest.mark.parametrize("override", [
    {"planning": {"replanning_frequency": 2}},
    {"planning": {"emergency_mode": "min_risk"}},
    {"prediction": {"mode": "constant_velocity"}},
    {"prediction": {"sensor_radius": 40.0}},
])
def test_mismatched_statics_raise(override):
    base = tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=30), _tcfg(),
                                           CPU))
    bad = tds.DeviceSimulation(Simulation(tfactory.make_highway(n_steps=30),
                                          _tcfg(**override), CPU))
    with pytest.raises(ValueError, match="planning statics"):
        tds.run_fleet([base, bad])


def test_chunk_buffers_refuse_other_shapes():
    sims = _members()
    runner = tds._Runner(sims[0], tds._fleet_stack(sims[:2]), 3)
    with pytest.raises(ValueError, match="does not fit"):
        runner.load(tds._fleet_stack(sims))


def test_device_fleet_gives_different_members():
    cfg = _tcfg()
    sims = workloads.device_fleet(5, CPU, "float64", seed=1, n_steps=20, config=cfg)
    assert [len(s.agents) for s in sims] == [1, 2, 1, 8, 1]
    assert len({s.statics for s in sims}) == 1
    # members 0 and 4 are both highways, with other speeds and gaps
    assert not np.allclose(sims[0].tensors.pose0, sims[4].tensors.pose0)
    again = workloads.device_fleet(5, CPU, "float64", seed=1, n_steps=20, config=cfg)
    np.testing.assert_array_equal(sims[3].tensors.pose0, again[3].tensors.pose0)
    results = tds.run_fleet(sims[:3], chunk=2)
    assert [r.trajectories.shape[1] for r in results] == [1, 2, 1]
    assert all(np.isfinite(r.trajectories).all() for r in results)
