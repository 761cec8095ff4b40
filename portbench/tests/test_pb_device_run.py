"""The device-resident run's configuration (`convoy8_run`) on the CPU at a
small size (three agents, four cycles, the first sampling level):

- the generator's ground truth is the Scenario the entry builds, and the
  program's own convoy factory's;
- the program's eager run against the plain closed-loop reference, cycle by
  cycle teacher-forced (`checks/device_run.py`), and the reference's
  free-running `simulate` against the program;
- planted faults come out not correct: a stale transition, an altered
  pick, a peer row left out, the sensor filter off, and the control (the
  reference in bfloat16 in the program's place);
- the checked cycles are live ones, where some agent still runs;
- the readers of the run's spans and counters: values on a stubbed
  snapshot and slice, None where the program has none.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.parallel import device_sim
from frenetix_tpu_torch.utils import tracing

from portbench import generate, judge, metrics, program_trace, run, spec, trace
from portbench.checks import device_run as check
from portbench.entries import device_run as entry
from portbench.generators import convoy_run
from portbench.reference import run as ref

CELL = "convoy8.device_run"
SEED = 2 ** 31 + 77


def tiny(**scenario):
    """The cell cut to three agents (ego and two converted vehicles; a third
    vehicle stays a scenario obstacle), four cycles and the first level."""
    cell = spec.cell(spec.load(), CELL)
    config = copy.deepcopy(spec.config(cell["config"]))
    mix = copy.deepcopy(spec.traffic(cell["traffic"]))
    config["scenario"].update(n_vehicles=3, recorded_steps=40, **scenario)
    config["simulation"].update(number_of_agents=2, max_steps_factor=0.3)
    config["planning"].update(sampling_min=1, sampling_max=2)
    config.update(agents=3, candidates_per_agent=180, warmup_requests=1,
                  trace_after_requests=0, trace_requests=2, check_requests=2,
                  check_cycles=4)
    mix["pool_requests"] = 2
    return config, mix


def _run(config, mix, seed=SEED):
    return run.run_cell(CELL, seed, 0.3, False, torch.device("cpu"), config=config,
                        mix=mix, setup_from=lambda: 0.0)


def _interacting(config, seed=SEED):
    """A pool whose agents meet: a slow converted vehicle 25 m ahead of the
    ego, and the scenario obstacle 10 m behind the second agent, faster, in
    its rear cone (the sensor filter drops it)."""
    line, pool = convoy_run.draw_pool(config, tiny()[1], seed)
    center, sc = line[0], config["scenario"]
    for req in pool:
        for i, (speed, s0) in enumerate(((2.0, 25.0), (10.0, 80.0), (16.0, 70.0))):
            req["vehicles"][i] = convoy_run.vehicle_states(center, speed, s0, sc["dt"],
                                                           sc["recorded_steps"])
    return line, pool


def test_the_generators_ground_truth_is_the_scenario_the_entry_builds():
    config = spec.config("convoy8_run")
    mix = spec.traffic("convoy_runs")
    lines, pool = generate.pool_of(config, mix, 2 ** 33 + 5)
    _, again = generate.pool_of(config, mix, 2 ** 33 + 5)
    assert all(np.array_equal(a["vehicles"], b["vehicles"]) for a, b in zip(pool, again))
    assert len({r["gap"] for r in pool}) == mix["pool_requests"]
    for req in pool[:2]:
        assert 9.0 <= req["ego_v"] <= 11.0 and 25.5 <= req["gap"] <= 34.5
        built = entry.build_scenario(config, lines[0], req)
        factory = scenario_factory.make_convoy(ego_v=req["ego_v"], gap=req["gap"])
        assert built.obstacles.keys() == factory.obstacles.keys()
        for oid, ob in factory.obstacles.items():
            mine = built.obstacles[oid]
            for t in range(config["scenario"]["recorded_steps"] + 1):
                a, b = ob.state_at_time(t), mine.state_at_time(t)
                assert np.array_equal(a.position, b.position) and (
                    a.orientation, a.velocity) == (b.orientation, b.velocity)
            assert (ob.length, ob.width) == (mine.length, mine.width)
        (lane,), (mine,) = factory.lanelets.values(), built.lanelets.values()
        assert np.array_equal(lane.polygon, mine.polygon)
        p, q = factory.planning_problems[60000], built.planning_problems[60000]
        assert np.array_equal(p.initial_state.position, q.initial_state.position)
        assert (p.initial_state.orientation, p.initial_state.velocity) == (
            q.initial_state.orientation, q.initial_state.velocity)
        g, h = p.goals[0], q.goals[0]
        assert np.array_equal(g.position_shape, h.position_shape)
        assert (g.time_interval, g.velocity_interval) == (h.time_interval,
                                                          h.velocity_interval)


@pytest.mark.parametrize("ego_v", [10.0, 1.5])     # 1.5: the low-velocity program
def test_the_program_against_the_reference(ego_v):
    config, mix = tiny(ego_v_mps=ego_v)
    result, checks, window = _run(config, mix)
    assert result["correct"] and result["failed"] == 0, checks
    assert window.cycles == 4 and window.candidates == 4 * 3 * 180
    lines, pool = generate.pool_of(config, mix, SEED)
    for k in range(len(pool)):
        got = window.answers[k]
        want = ref.simulate(config, pool[k], lines=lines)
        answer = entry.Entry.answer(None, got)
        assert np.array_equal(answer["found"], want["found"])
        assert np.array_equal(answer["status_steps"], want["status_steps"])
        assert np.array_equal(answer["status"], want["status"])
        for name, tol in (("x_cl", 1e-4), ("sel", 1e-5), ("traj", 1e-4), ("cost", 1e-3)):
            assert np.abs(np.asarray(answer[name], float) - want[name]).max() < tol, name
        assert check.compare(config, lines, pool[k], want, device="cpu") == dict.fromkeys(
            check.NUMBERS, 0.0)


def _stale(answer):
    answer["x_cl"] = np.concatenate([answer["x_cl"][:1], answer["x_cl"][:-1]])
    return answer


def _altered(answer):
    sel = np.array(answer["sel"])
    sel[1:, :, 2] = np.where(sel[1:, :, 2] > 0.0, -1.5, 1.5)
    answer["sel"] = sel
    return answer


@pytest.mark.parametrize("fault", ["stale_transition", "altered_pick", "peer_left_out",
                                   "sensor_off"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    config, mix = tiny()
    lines, pool = _interacting(config)
    monkeypatch.setattr(generate, "pool_of", lambda *a: (lines, pool))
    result, _, _ = _run(config, mix)
    assert result["correct"]
    if fault in ("stale_transition", "altered_pick"):
        own = entry.Entry.answer
        plant = _stale if fault == "stale_transition" else _altered
        monkeypatch.setattr(entry.Entry, "answer", lambda self, res: plant(own(self, res)))
    elif fault == "peer_left_out":
        rows = device_sim.agent_plan_predictions

        def without_agent_1(*args, active, **kwargs):
            return rows(*args, active=active & (torch.arange(active.shape[-1]) != 1),
                        **kwargs)
        monkeypatch.setattr(device_sim, "agent_plan_predictions", without_agent_1)
    else:
        build = entry.frenetix_config

        def blind(config_):
            cfg = build(config_)
            cfg.prediction.use_sensor_model = False
            return cfg
        monkeypatch.setattr(entry, "frenetix_config", blind)
    result, checks, _ = _run(config, mix)
    assert not result["correct"], checks


def test_the_control_is_not_correct():
    config, mix = tiny()
    lines, pool = generate.pool_of(config, mix, SEED + 1)
    lims = judge.limits("convoy8_run", config)
    for req in pool:
        control = check.control_answer(config, lines, req, dtype=torch.bfloat16,
                                       device="cpu")
        assert not judge.verdict(check.compare(config, lines, req, control, device="cpu"),
                                 lims)


def test_the_checked_cycles_are_drawn_among_live_cycles():
    """A cycle is live where some agent executes its first step; a run whose
    agents have all finished checks none of its dead tail."""
    config, _ = tiny()
    k = config["planning"]["replanning_frequency"]
    steps = np.full((30, 3), ref.RUNNING)
    steps[7:, 0] = ref.SUCCESS                  # reached its goal in cycle 2
    steps[9:, 1] = ref.COLLISION                # collided in cycle 3's first step
    steps[15:, 2] = ref.TIMELIMIT               # stopped at cycle 5's first step
    answer = dict(status_steps=steps, x_cl=np.zeros((10, 3, 6)))
    assert check.live_cycles(config, answer).tolist() == [0, 1, 2, 3, 4]
    assert k == 3
    request = dict(ego_v=10.3, gap=31.7)
    for draws in (2, 4, 9):
        got = check.checked_cycles(dict(config, check_cycles=draws), request, answer)
        assert got == sorted(set(got)) and set(got) <= {0, 1, 2, 3, 4}
        assert len(got) == min(draws, 5)
    steps[:] = ref.SUCCESS
    assert check.checked_cycles(config, request, answer) == []


def _traced(snapshot, host=(), cycles=142):
    ran = run.Run(entry=type("E", (), {"cycles": cycles})(), k1_shape=(1, 1, 1),
                  captures=0)
    host = [(0.0, 1000.0, trace.REQUEST_SPAN), (1000.0, 2000.0, trace.REQUEST_SPAN),
            *host]
    ran.program_trace = program_trace.ProgramTrace(
        slice=trace.Slice(device=[], host=host, requests=2), snapshot=snapshot)
    return ran


def test_the_run_readers_on_a_stubbed_snapshot_and_slice():
    host = [(10.0, 20.0, "frenetix.device_sim.load"), (20.0, 25.0, "frenetix.device_sim.reset"),
            (25.0, 735.0, "frenetix.device_sim.replay"),
            (900.0, 930.0, "frenetix.device_sim.fetch"),
            (930.0, 935.0, "frenetix.device_sim.finalize"),
            (1025.0, 1735.0, "frenetix.device_sim.replay")]
    ran = _traced({"spans": {}, "counters": {"device_sim.cycles": 284},
                   "device_counters": {}}, host)
    assert metrics.load("run_replay_ms").read(ran) == pytest.approx(0.71 / 142)
    assert metrics.load("run_io_ms").read(ran) == pytest.approx(0.025)
    assert metrics.load("run_captures").read(ran) == 0.0


@pytest.mark.parametrize("name", ["run_replay_ms", "run_io_ms", "run_captures"])
def test_the_run_readers_find_nothing_without_the_runs_spans(name):
    empty = _traced({"spans": {}, "counters": {}, "device_counters": {}})
    assert metrics.load(name).read(empty) is None
    bare = run.Run(entry=None, k1_shape=(1, 1, 1), captures=0, traced=[])
    assert metrics.load(name).read(bare) is None


def test_the_run_cycle_reader_times_the_traced_requests_again(monkeypatch):
    """It warms up on the traced requests with tracing on, as many runs as
    before the window, runs them once more and reads the device span; None
    without the span (the CPU, or a program without it) or without traced
    requests."""
    seen = []

    class Stub:
        cycles = 142
        config = {"warmup_requests": 3}

        def request(self, prepared):
            seen.append((prepared, tracing.enabled()))
            tracing.count("device_sim.cycles", self.cycles)

    spans = {"frenetix.device_sim.cycles": (1136.0, 2)}
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": spans})
    ran = run.Run(entry=Stub(), k1_shape=(1, 1, 1), captures=0, traced=["a", "b"])
    assert metrics.load("run_cycle_ms").read(ran) == pytest.approx(4.0)
    assert seen == [("a", True), ("b", True), ("a", True), ("a", True), ("b", True)]
    assert not tracing.enabled()
    spans.clear()
    assert metrics.load("run_cycle_ms").read(ran) is None
    assert metrics.load("run_cycle_ms").read(
        run.Run(entry=Stub(), k1_shape=(1, 1, 1), captures=0, traced=[])) is None
