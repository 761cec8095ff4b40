"""The behavior planner in the port's host simulation, end to end.

- One agent: the port's `Simulation` against the JAX `Simulation` at float64
  with `behavior.use_behavior_planner` on a red light (the ego holds behind
  the stop line, then goes), a stop sign's full stop and the behavior's own
  lane change (the reference path is swapped): equal statuses and step
  counts, every executed position within 1e-9 m.
- The command line: a behavior.yaml in `--config-dir` turns the planner on
  in the host loop and in the device-resident run.
- Many agents: a small convoy with behavior (each module observes its live
  peers through a WorldView), batched against sequential in the port:
  equal statuses, and every agent's executed states within 1e-9 m up to the
  step at which the first agent retires (the batched step retires an agent
  at its goal one step before the sequential loop, in both packages).
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.sim.world_view import WorldView
from frenetix_tpu_torch.utils.config import FrenetixConfig

from torch_parity import agent_states, behavior_recorder, coarse_sampling

torch.set_num_threads(1)

CPU = torch.device("cpu")
POS_TOL = 1e-9


def _behavior(cfg):
    cfg.behavior.use_behavior_planner = True
    return cfg


@pytest.mark.parametrize("family", ["traffic_light", "stop_sign", "lane_change"])
def test_behavior_simulation_matches_jax(family):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.sim.simulation import Simulation as JSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    tsim = Simulation(getattr(tfactory, f"make_{family}")(),
                      _behavior(FrenetixConfig(dtype="float64")), CPU)
    swaps = behavior_recorder(tsim)
    tres = tsim.run()
    jsim = JSimulation(getattr(jfactory, f"make_{family}")(),
                       _behavior(JConfig(dtype="float64")))
    jres = jsim.run()
    assert tres.success, tres.agent_messages
    assert {k: int(v) for k, v in tres.agent_status.items()} == \
        {k: int(v) for k, v in jres.agent_status.items()}
    assert tres.steps == jres.steps
    tstates, jstates = agent_states(tsim), agent_states(jsim)
    for aid in jstates:
        assert tstates[aid].shape == jstates[aid].shape
        np.testing.assert_allclose(tstates[aid][:, :2], jstates[aid][:, :2],
                                   rtol=0, atol=POS_TOL)
    xs, vs = tstates[60000][:, 0], tstates[60000][:, 2]
    if family == "traffic_light":
        # red for the first 90 steps: the ego holds behind the line at x = 90
        assert xs[:85].max() < 90.0 and vs[60:85].min() < 0.5
    elif family == "stop_sign":
        assert vs.min() < 0.5, "no full stop at the sign"
    else:
        assert swaps, "the behavior planner changed no lane"
        assert tstates[60000][-1, 1] > 2.0, "the ego did not end on the left lane"


def test_behavior_batched_equals_sequential_on_a_convoy():
    runs = {}
    for batched in (False, True):
        cfg = coarse_sampling(_behavior(FrenetixConfig(dtype="float64")))
        cfg.simulation.start_multiagent = True
        cfg.simulation.batched_device_agents = batched
        sim = Simulation(tfactory.make_convoy(n_vehicles=2, length=300.0, n_steps=120),
                         cfg, CPU)
        assert len(sim.agents) == 3
        # each behavior module sees the live peers, not their recordings
        assert all(isinstance(a.behavior.bm.world, WorldView) for a in sim.agents)
        assert a_id_not_in_own_view(sim)
        runs[batched] = (sim, sim.run())
    (seq_sim, seq), (bat_sim, bat) = runs[False], runs[True]
    assert bat.agent_status == seq.agent_status
    assert any(int(s) == 2 for s in seq.agent_status.values())
    s_seq, s_bat = agent_states(seq_sim), agent_states(bat_sim)
    # up to the first retirement: the shortest history of either run
    first_done = min(len(h) for run in (s_seq, s_bat) for h in run.values()) - 1
    assert first_done > 20
    for aid in s_seq:
        np.testing.assert_allclose(s_bat[aid][:first_done], s_seq[aid][:first_done],
                                   rtol=0, atol=POS_TOL, err_msg=str(aid))
    # the ego is no agent anyone retires early: equal to the end
    np.testing.assert_allclose(s_bat[60000], s_seq[60000], rtol=0, atol=POS_TOL)


def a_id_not_in_own_view(sim):
    """No WorldView lists its own agent among the obstacles."""
    return all(a.id not in a.behavior.bm.world.obstacles for a in sim.agents)


@pytest.mark.parametrize("mode", [[], ["--device-sim"], ["--multiagent", "--batched-agents"]])
def test_run_scenario_reads_behavior_yaml(tmp_path, capsys, mode):
    from frenetix_tpu_torch import run_scenario

    (tmp_path / "behavior.yaml").write_text("use_behavior_planner: true\n")
    (tmp_path / "planning.yaml").write_text("sampling_min: 1\nsampling_max: 2\n")
    seen = []
    real = run_scenario.Simulation

    def recording(scenario, config, device, **loggers):
        seen.append(config.behavior.use_behavior_planner)
        return real(scenario, config, device, **loggers)

    run_scenario.Simulation = recording
    try:
        rc = run_scenario.main(["stop_sign", "--device", "cpu", "--config-dir",
                                str(tmp_path), "--logs", str(tmp_path / "logs"), *mode])
    finally:
        run_scenario.Simulation = real
    assert seen == [True]
    assert rc == 0
    assert "status=COMPLETED_SUCCESS" in capsys.readouterr().out
