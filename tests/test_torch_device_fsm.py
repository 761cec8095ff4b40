"""The behavior FSM inside the port's device-resident run.

- `behavior.device_fsm`: `build_fsm_tensors` equal to the JAX package's
  tables, and `make_fsm_step` against the JAX `make_fsm_step` on crafted
  carries (random poses along the route, situations, goal rows, flags and
  counters), one jitted JAX step per case: codes equal, floats within
  1e-12.  No JAX `DeviceSimulation` is built: its behavior runs compile for
  minutes.
- `parallel.device_sim` on the CPU (the eager loop), float64, on short
  variants of the families with level-1 sampling:
  - the in-run FSM against the port's host sequential loop on a red light
    and a stop sign (statuses, steps, positions within 1e-9 m), with one
    fetch per run;
  - the forced "hybrid" run equal to the in-run FSM, with one fetch per
    cycle;
  - lane_change falls back at construction (navigation lane changes), a
    turn for its goal type;
  - behavior_overtake is in scope at construction, bails at run time and
    equals the forced hybrid run, whose swapped paths outgrow the tables;
  - a fleet of two behavior members equals their solo runs, with the FSM in
    the run and on the hybrid path.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.behavior import device_fsm as tfsm
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.parallel import device_sim as tds
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import FrenetixConfig
from torch_parity import coarse_sampling, host_count

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-12
POS_TOL = 1e-9

# short variants: the light is red for 80 steps, the line 50 m ahead
_SHORT = {
    "traffic_light": dict(length=110.0, stop_at=50.0, red_steps=80, n_steps=150),
    "stop_sign": dict(length=110.0, stop_at=50.0, n_steps=130),
    "crosswalk": dict(length=100.0, cross_at=45.0, n_steps=130),
    "yield_sign": dict(length=110.0, stop_at=50.0, n_steps=130),
    "behavior_overtake": dict(length=160.0, lead_gap=30.0, n_steps=80),
    "convoy": dict(n_vehicles=2, length=300.0, n_steps=120),
    "lane_change": {},
    "turn_left": {},
}


def _cfg(device_fsm="auto", multi=False, factory_cfg=FrenetixConfig):
    cfg = coarse_sampling(factory_cfg(dtype="float64"))
    cfg.behavior.use_behavior_planner = True
    cfg.behavior.device_fsm = device_fsm
    cfg.simulation.start_multiagent = multi
    return cfg


def _sim(family, device_fsm="auto"):
    multi = family == "convoy"
    return Simulation(getattr(tfactory, f"make_{family}")(**_SHORT[family]),
                      _cfg(device_fsm, multi), CPU)


def _assert_equal_runs(a, b, what):
    assert [int(s) for s in a.status] == [int(s) for s in b.status], what
    assert a.steps == b.steps, what
    np.testing.assert_allclose(a.trajectories[:a.steps], b.trajectories[:b.steps],
                               rtol=0, atol=POS_TOL, err_msg=what)


# ------------------------------------------------------------ the FSM step


def _jax_sim(family):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.sim.simulation import Simulation as JSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    return JSimulation(getattr(jfactory, f"make_{family}")(**_SHORT[family]),
                       _cfg(multi=family == "convoy", factory_cfg=JConfig))


def _crafted_inputs(rng, sim, ft, n_cycles, k):
    """A random but plausible FSM carry and pose of every agent."""
    a_n = len(sim.agents)
    g_n, l_n = ft.g_valid.shape[1], ft.ll_valid.shape[0]
    center = np.zeros((a_n, 2))
    theta = np.zeros(a_n)
    for i, a in enumerate(sim.agents):
        frame = a.behavior.bm.PP_state.frame
        s = rng.uniform(0.0, frame.length)
        center[i] = frame.to_cartesian(s, rng.uniform(-1.0, 1.0))
        theta[i] = rng.uniform(-0.2, 0.2)
    c = int(rng.integers(0, n_cycles))
    carry = dict(
        sit=rng.integers(0, 8, a_n), goal_idx=rng.integers(-1, g_n, a_n),
        prev_type=rng.integers(0, 9, a_n), slowing=rng.random(a_n) < 0.5,
        waiting=rng.random(a_n) < 0.5, wait_counter=rng.integers(0, 14, a_n),
        hold_has=rng.random(a_n) < 0.5, hold_s=rng.uniform(0.0, 100.0, a_n),
        stopdist_has=rng.random(a_n) < 0.5, stopdist=rng.uniform(-5.0, 40.0, a_n),
        mode_final=rng.random(a_n) < 0.3, dvsp_prev=rng.uniform(0.0, 12.0, a_n),
        dvsp_has=rng.random(a_n) < 0.7, cur_ll=rng.integers(-1, l_n, a_n),
        bail=np.asarray(False))
    for name in ("sit", "goal_idx", "prev_type", "wait_counter", "cur_ll"):
        carry[name] = carry[name].astype(np.int32)
    return dict(carry=carry, c=c, t0=c * k, center=center, theta=theta,
                v=rng.choice([0.0, 0.2, 3.0, 9.5, 14.0], a_n) + rng.uniform(0, 0.1, a_n),
                running=rng.random(a_n) < 0.85, peer_present=rng.random(a_n) < 0.8)


@pytest.mark.parametrize("family", ["traffic_light", "stop_sign", "crosswalk",
                                    "behavior_overtake", "convoy"])
def test_fsm_step_matches_jax_on_crafted_carries(family):
    import jax
    import jax.numpy as jnp
    from frenetix_tpu.behavior import device_fsm as jfsm

    jsim, tsim = _jax_sim(family), _sim(family)
    jft, jok, _ = jfsm.build_fsm_tensors(jsim, np.float64)
    tft, tok, _ = tfsm.build_fsm_tensors(tsim, np.float64)
    assert jok and tok
    for f in fields(tft):         # the host tables are a copy: equal arrays
        np.testing.assert_array_equal(getattr(tft, f.name),
                                      np.asarray(getattr(jft, f.name)), err_msg=f.name)
    j0, t0_ = (jfsm.fsm_carry0(jsim.agents, jsim.scenario, np.float64),
               tfsm.fsm_carry0(tsim.agents, tsim.scenario, np.float64))
    for f in fields(t0_):
        np.testing.assert_array_equal(getattr(t0_, f.name), getattr(j0, f.name))

    cfg = tsim.config
    k = cfg.planning.replanning_frequency
    n_cycles = tft.tl_code.shape[0]
    jstep = jax.jit(jfsm.make_fsm_step(jsim.config, jsim.config.vehicle,
                                       cfg.planning.dt, k))
    tstep = tfsm.make_fsm_step(cfg, cfg.vehicle, cfg.planning.dt, k)
    jft_d = jfsm.FSMTensors(*(jnp.asarray(getattr(jft, f.name)) for f in fields(tft)))
    tft_d = tft.to(CPU, torch.float64)
    rng = np.random.default_rng(7)
    codes_seen = set()
    for _ in range(8):
        x = _crafted_inputs(rng, tsim, tft, n_cycles, k)
        jcarry = jfsm.FSMCarry(**{n: jnp.asarray(v) for n, v in x["carry"].items()})
        tcarry = tfsm.FSMCarry(**x["carry"]).to(CPU, torch.float64)
        jout = jstep(jft_d, jcarry, jnp.int32(x["c"]), jnp.int32(x["t0"]),
                     jnp.asarray(x["center"]), jnp.asarray(x["theta"]),
                     jnp.asarray(x["v"]), jnp.asarray(x["running"]),
                     jnp.asarray(x["peer_present"]))
        tout = tstep(tft_d, tcarry, torch.tensor([x["c"]]), torch.tensor([x["t0"]]),
                     torch.as_tensor(x["center"]), torch.as_tensor(x["theta"]),
                     torch.as_tensor(x["v"]), torch.as_tensor(x["running"]),
                     torch.as_tensor(x["peer_present"]))
        for name in [f.name for f in fields(tcarry)]:
            a = np.asarray(getattr(jout[0], name))
            b = getattr(tout[0], name).numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
        for i, what in ((1, "v_des"), (2, "stop_s"), (3, "stop_v")):
            np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                       rtol=TOL, atol=TOL, err_msg=what)
        codes_seen.update(tout[0].sit.tolist())
    assert len(codes_seen) > 1


# ------------------------------------------------------- the device run


@pytest.mark.parametrize("family", ["traffic_light", "stop_sign"])
def test_in_run_fsm_matches_the_host_sequential_loop(family):
    ds = tds.DeviceSimulation(_sim(family))
    assert ds.fsm_in_scan, ds.fsm_reason
    fetches = host_count("device_sim.fetches")
    dres = ds.run()
    assert host_count("device_sim.fetches") == fetches + 1, \
        "the in-run FSM keeps one fetch per run"
    assert not dres.extras.get("bailed")
    hsim = _sim(family)
    hres = hsim.run()
    assert hres.success
    assert [int(s) for s in dres.status] == [int(s) for s in hres.agent_status.values()]
    assert dres.steps == hres.steps
    host = np.array([s.position for s in hres.histories[60000][1:]])
    np.testing.assert_allclose(dres.trajectories[:len(host), 0, :2], host,
                               rtol=0, atol=POS_TOL)
    # the ego holds behind the line (x = 50) while it is red or must stop
    x, v = dres.trajectories[:dres.steps, 0, 0], dres.trajectories[:dres.steps, 0, 3]
    assert v.min() < 1.0 and x[:75].max() < 50.0, "the ego did not hold at the line"


def test_forced_hybrid_equals_the_in_run_fsm():
    in_run = tds.DeviceSimulation(_sim("traffic_light")).run()
    ds = tds.DeviceSimulation(_sim("traffic_light", device_fsm="hybrid"))
    assert not ds.fsm_in_scan and "hybrid" in ds.fsm_reason
    fetches = host_count("device_sim.fetches")
    hybrid = ds.run()
    # one small fetch per cycle and the run's last one
    fetched = host_count("device_sim.fetches") - fetches
    assert fetched == ds.n_cycles + 1 == hybrid.extras["fetches"]
    _assert_equal_runs(hybrid, in_run, "hybrid vs in-run FSM")


@pytest.mark.parametrize("family,reason", [("lane_change", "navigation lane changes"),
                                           ("turn_left", "goal type")])
def test_unsupported_scopes_fall_back_at_construction(family, reason):
    ds = tds.DeviceSimulation(_sim(family))
    assert not ds.fsm_in_scan and reason in ds.fsm_reason
    assert ds.tensors.fsm is None


def test_overtake_bails_to_the_hybrid_path(monkeypatch):
    ds = tds.DeviceSimulation(_sim("behavior_overtake"))
    assert ds.fsm_in_scan, "in scope at construction"
    bailed = ds.run()
    assert bailed.extras["bailed"], "the wish to overtake must bail"
    bodies = []
    init = tds._Runner.__init__
    monkeypatch.setattr(tds._Runner, "__init__",
                        lambda self, *a, **k: (bodies.append(1), init(self, *a, **k))[1])
    forced = tds.DeviceSimulation(_sim("behavior_overtake", device_fsm="hybrid")).run()
    # the lane changes swap in paths longer than the tables: the run goes on
    # in larger buffers (a new capture on the card)
    assert len(bodies) > 1
    _assert_equal_runs(bailed, forced, "bailed vs forced hybrid")


@pytest.mark.parametrize("device_fsm", ["auto", "hybrid"])
def test_behavior_fleet_equals_solo_runs(device_fsm):
    families = ("traffic_light", "stop_sign")
    sims = [tds.DeviceSimulation(_sim(f, device_fsm)) for f in families]
    assert all(s.fsm_in_scan == (device_fsm == "auto") for s in sims)
    fetches = host_count("device_sim.fetches")
    fleet = tds.run_fleet(sims)
    if device_fsm == "auto":
        assert host_count("device_sim.fetches") == fetches + 1
    solo = [tds.DeviceSimulation(_sim(f, device_fsm)).run() for f in families]
    for f, a, b in zip(families, fleet, solo):
        _assert_equal_runs(a, b, f)
        assert a.extras["fleet_size"] == 2
