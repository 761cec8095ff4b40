"""The fleet's configuration (`fleet32_run`, cell `fleet32.device`) on the
CPU:

- the generator is deterministic from the seed, follows the family rule,
  and its members are the program's own factory families;
- the entry builds a fleet of the cell's size: 32 members, 96 agents,
  142 cycles, 10,188,800 candidates;
- the harness takes the cell from its files alone;
- at a small size (four members, one of each family, short runs, the
  first sampling level) the program is correct, and so is the reference's
  own answer in its place; planted faults are not: two members' answers
  swapped, a padding row's pick leaked into a member's answer, an overtake
  member's answer from the program with a one-lane corridor, and the
  control (the reference in bfloat16);
- the reference (`reference/fleet.py`) reduces to `reference/run.py` on a
  convoy member, scans the overtake's corridor over both lanes as the
  program does, and holds the program's overtake to the cell's limits
  where the bfloat16 reference fails them;
- the readers `fleet_row_fill` and `fleet_load_ms`.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory

from portbench import generate, judge, metrics, program_trace, run, spec, trace
from portbench.checks import fleet_run as check
from portbench.entries import fleet_run as entry
from portbench.generators import fleet_run as gen
from portbench.reference import fleet as fref
from portbench.reference import run as ref

CELL = "fleet32.device"
CONFIG = "fleet32_run"
SEED = 2 ** 31 + 5
CPU = torch.device("cpu")


def tiny():
    """The cell cut to four members (one of each family, the convoy of three
    agents), 60 recorded steps run for 10 cycles at the first level, the
    overtake's lead 14 m ahead (the ego takes the left lane within the
    run), every live cycle checked."""
    cell = spec.cell(spec.load(), CELL)
    config = copy.deepcopy(spec.config(cell["config"]))
    mix = copy.deepcopy(spec.traffic(cell["traffic"]))
    for fam in config["families"].values():
        fam["recorded_steps"] = 60
    config["families"]["convoy"]["n_vehicles"] = 2
    config["families"]["overtake"]["lead_gap_m"] = 14.0
    config["simulation"]["max_steps_factor"] = 0.5
    config["planning"].update(sampling_min=1, sampling_max=2)
    config.update(agents=7, candidates_per_agent=180, warmup_requests=1,
                  trace_after_requests=0, trace_requests=2, check_requests=1,
                  check_cycles=100)
    mix["members"] = 4
    return config, mix


@pytest.fixture(scope="module")
def small():
    """The tiny cell's pool, its entry and the program's answer to each
    fleet."""
    torch.set_num_threads(4)
    config, mix = tiny()
    lines, pool = generate.pool_of(config, mix, SEED)
    ent = entry.Entry(config, lines, CPU)
    fleets = [ent.prepare(req) for req in pool]
    answers = [ent.answer(ent.request(f)) for f in fleets]
    return config, lines, pool, ent, fleets, answers


def _correct(config, lines, req, answer):
    got = check.compare(config, lines, req, answer, device=CPU)
    return judge.verdict(got, judge.limits(CONFIG, config)), got


def test_the_generator_is_deterministic_and_follows_the_family_rule():
    config, mix = spec.config(CONFIG), spec.traffic("fleet_runs")
    lines, pool = generate.pool_of(config, mix, 2 ** 33 + 5)
    _, again = generate.pool_of(config, mix, 2 ** 33 + 5)
    _, other = generate.pool_of(config, mix, 2 ** 33 + 6)
    assert len(pool) == 2 and all(len(f["members"]) == 32 for f in pool)
    for a, b, c in zip(pool[0]["members"], again[0]["members"], other[0]["members"]):
        assert np.array_equal(a["vehicles"], b["vehicles"]) and a["ego_v"] == b["ego_v"]
        assert a["ego_v"] != c["ego_v"]
    for i, m in enumerate(pool[1]["members"]):
        fam = config["families"][gen.FAMILIES[i % 4]]
        assert m["family"] == gen.FAMILIES[i % 4]
        assert 0.9 * fam["ego_v_mps"] <= m["ego_v"] <= 1.1 * fam["ego_v_mps"]
        assert m["multiagent"] == fam["multiagent"]
    assert lines.shape == (0, 0, 2)


def _factory(member):
    """The program's factory scenario of a member's family, speed and gap."""
    name = member["family"]
    if name == "highway":
        return scenario_factory.make_highway(ego_v=member["ego_v"], lead_gap=member["gap"])
    if name == "overtake":
        return scenario_factory.make_overtake(ego_v=member["ego_v"], lead_gap=member["gap"])
    if name == "curve":
        return scenario_factory.make_curve(ego_v=member["ego_v"], lead_v=member["gap"])
    return scenario_factory.make_convoy(ego_v=member["ego_v"], gap=member["gap"])


def test_the_generators_families_are_the_programs_factory_scenarios():
    config = spec.config(CONFIG)
    _, pool = generate.pool_of(config, spec.traffic("fleet_runs"), 2 ** 32 + 9)
    for member in pool[0]["members"][:4]:
        fam = config["families"][member["family"]]
        want = _factory(member)
        built = entry.build_scenario(member, fam["dt"])
        assert built.obstacles.keys() == want.obstacles.keys()
        for oid, ob in want.obstacles.items():
            mine = built.obstacles[oid]
            for t in range(fam["recorded_steps"] + 1):
                a, b = ob.state_at_time(t), mine.state_at_time(t)
                assert np.allclose(a.position, b.position, rtol=0, atol=1e-9)
                assert abs(a.orientation - b.orientation) < 1e-12
                assert a.velocity == pytest.approx(b.velocity, abs=1e-12)
        assert len(built.lanelets) == len(want.lanelets)
        for lane, mine in zip(want.lanelets.values(), built.lanelets.values()):
            assert np.allclose(lane.polygon, mine.polygon, rtol=0, atol=1e-9)
            assert (lane.adj_left, lane.adj_right) == (mine.adj_left, mine.adj_right)
        p, q = want.planning_problems[60000], built.planning_problems[60000]
        assert np.allclose(p.initial_state.position, q.initial_state.position, atol=1e-12)
        assert p.initial_state.orientation == pytest.approx(q.initial_state.orientation)
        assert p.initial_state.velocity == pytest.approx(q.initial_state.velocity)
        g, h = p.goals[0], q.goals[0]
        assert np.allclose(g.position_shape, h.position_shape, atol=1e-12)
        assert g.time_interval == h.time_interval
        assert np.allclose(g.velocity_interval, h.velocity_interval)


def test_the_entry_builds_a_fleet_of_the_cells_size():
    torch.set_num_threads(4)
    config = spec.config(CONFIG)
    lines, pool = generate.pool_of(config, spec.traffic("fleet_runs"), SEED)
    ent = entry.Entry(config, lines, CPU)
    fleet = ent.prepare(pool[0])
    assert len(fleet) == 32 and sum(len(ds.agents) for ds in fleet) == 96
    assert sorted({ds.n_cycles for ds in fleet}) == [114, 142]
    assert ent.cycles == 142
    assert ent.candidates == 12_736 * 800 == 10_188_800
    rows = max(ds.tensors.ref.s.shape[-1] for ds in fleet)
    assert ent.k1_shape == (32 * 8 * rows, 7, 32 * 8 * 800 * 31)


def test_the_harness_takes_the_cell_from_its_files_alone():
    bench = spec.load()
    cell = spec.cell(bench, CELL)
    assert cell["chips"] == 1 and (cell["config"], cell["traffic"]) == (CONFIG, "fleet_runs")
    assert spec.bad_names(bench) == []
    config = spec.config(cell["config"])
    assert {k: config[k] for k in ("entry", "generator", "check")} == dict.fromkeys(
        ("entry", "generator", "check"), "fleet_run")
    assert judge.limits(CONFIG) == judge.limits("convoy8_run")
    names = {m["name"] for m in spec.metrics_of(bench, CELL, "per_layer")}
    assert names == {"run_cycle_ms.fleet", "run_captures.fleet", "k1_roofline.fleet",
                     "fleet_row_fill", "fleet_load_ms", "device_idle_share.fleet",
                     "run_replay_ms.fleet"}
    assert all(callable(metrics.load(n).read) for n in names)
    assert {m["name"] for m in spec.metrics_of(bench, CELL, "end_to_end")} == {
        "setup_s", "cycle_ms_p95", "cand_evals_per_s"}


def test_the_small_cell_runs_correct_through_the_harness():
    config, mix = tiny()
    result, checks, window = run.run_cell(CELL, SEED, 0.3, False, CPU, config=config,
                                          mix=mix, setup_from=lambda: 0.0)
    assert result["correct"] and result["failed"] == 0, checks
    assert window.cycles == 10
    assert window.candidates == (10 + 2 * 10 + 10 + 3 * 10) * 180


def test_the_program_and_the_references_own_answer_are_correct(small):
    config, lines, pool, _, _, answers = small
    for req, answer in zip(pool, answers):
        ok, got = _correct(config, lines, req, answer)
        assert ok and got == dict.fromkeys(check.NUMBERS, 0.0) | {
            k: got[k] for k in ("traj_err_m", "cost_err_rel", "transition_m")}, got
        control = check.control_answer(config, lines, req, dtype=torch.float64, device=CPU)
        assert _correct(config, lines, req, control)[0]


def test_the_checked_members_are_one_of_each_family():
    config = spec.config(CONFIG)
    _, pool = generate.pool_of(config, spec.traffic("fleet_runs"), SEED)
    for req in pool:
        picks = check.checked_members(req)
        assert sorted(req["members"][i]["family"] for i in picks) == sorted(gen.FAMILIES)
        assert picks == check.checked_members(copy.deepcopy(req))
    assert check.checked_members(pool[0]) != check.checked_members(pool[1])


def _swapped(small):
    """The checked highway member's answer and that of another highway."""
    config, _, pool, _, _, answers = small
    config = copy.deepcopy(config)
    req = copy.deepcopy(pool[0])
    req["members"].append(pool[1]["members"][0])
    answer = dict(answers[0], members=list(answers[0]["members"]) + [answers[1]["members"][0]])
    i = next(i for i in check.checked_members(req) if req["members"][i]["family"] == "highway")
    j = 4 if i == 0 else 0
    answer["members"][i], answer["members"][j] = answer["members"][j], answer["members"][i]
    return config, req, answer


def _padding_pick(small):
    """The highway member's ego pick replaced by a padding row's: the agent
    rows past its own that the fleet stacks (inactive copies of its ego)."""
    config, _, pool, ent, fleets, answers = small
    ent.request(fleets[0])
    out = ent.runner.runner.out
    member = copy.deepcopy(answers[0]["members"][0])
    c_n = len(member["sel"])
    member["sel"] = out["sel"][:c_n, 0, 1:2].numpy()
    member["found"] = out["found"][:c_n, 0, 1:2].numpy()
    member["cost"] = out["cost"][:c_n, 0, 1:2].numpy()
    answer = dict(answers[0], members=[member] + list(answers[0]["members"][1:]))
    return config, pool[0], answer


def _one_lane(small):
    """The overtake member's answer from the program over its right lane
    alone."""
    config, lines, pool, _, _, answers = small
    member = copy.deepcopy(pool[0]["members"][1])
    member["lanes"] = member["lanes"][:1]
    ent = entry.Entry(config, lines, CPU)
    fleet = ent.prepare({"members": [member]})
    mine = ent.answer(ent.request(fleet))["members"][0]
    answer = dict(answers[0], members=[answers[0]["members"][0], mine]
                  + list(answers[0]["members"][2:]))
    return config, pool[0], answer


def _control(small):
    config, lines, pool, _, _, _ = small
    return config, pool[0], check.control_answer(config, lines, pool[0],
                                                 dtype=torch.bfloat16, device=CPU)


@pytest.mark.parametrize("fault", [_swapped, _padding_pick, _one_lane, _control],
                         ids=["swapped", "padding_pick", "one_lane", "bfloat16_control"])
def test_planted_faults_are_not_correct(small, fault):
    config, req, answer = fault(small)
    ok, got = _correct(config, small[1], req, answer)
    assert not ok, got


def test_on_a_convoy_member_the_fleet_reference_is_run_py(small):
    config, _, pool, _, _, _ = small
    member = pool[0]["members"][3]
    assert member["family"] == "convoy"
    mine = fref.setup(config, member)
    want = ref.setup(config, member["lanes"][0], member)
    for name in ("pose0", "x_cl0", "rings", "goal_v", "goal_s", "goal_t", "goal_v_mean",
                 "bank0", "bank_len0", "others", "other_size", "corr"):
        assert np.array_equal(getattr(mine, name), getattr(want, name)), name
    assert (mine.max_steps, mine.n_cycles, mine.k) == (want.max_steps, want.n_cycles, want.k)
    assert np.array_equal(mine.tab.xy, want.tab.xy)
    got = fref.simulate(config, member)
    again = ref.simulate(config, member, lines=member["lanes"][None, 0])
    for name in got:
        assert np.array_equal(got[name], again[name]), name


def test_the_overtake_corridor_spans_both_lanes_as_the_programs(small):
    config, _, pool, _, fleets, _ = small
    member, ds = pool[0]["members"][1], fleets[0][1]
    su = fref.setup(config, member)
    width = member["lane_width"]
    mid = len(su.corr) // 2
    assert su.corr[mid, 0] == pytest.approx(-width / 2, abs=0.13)
    assert su.corr[mid, 1] == pytest.approx(1.5 * width, abs=0.13)
    prog = np.asarray(ds.tensors.corridors[0], np.float64)
    assert prog.shape == su.corr.shape
    assert np.abs(prog - su.corr).max() < 1e-6
    alone = fref.setup(config, dict(member, lanes=member["lanes"][:1]))
    assert alone.corr[mid, 1] == pytest.approx(width / 2, abs=0.13)


def test_the_reference_holds_the_programs_overtake_and_fails_bfloat16(small):
    config, _, pool, _, _, answers = small
    member = pool[0]["members"][1]
    lims = judge.limits(CONFIG, config)
    got = check.member_numbers(config, member, answers[0]["members"][1], device=CPU)
    assert got["pick_gap"] <= lims["pick_gap"] and got["traj_err_m"] <= lims["traj_err_m"]
    low = fref.simulate(config, member, dtype=torch.bfloat16)
    bad = check.member_numbers(config, member, low, device=CPU)
    assert not judge.verdict(bad, lims), bad


def _traced(snapshot, host=()):
    ran = run.Run(entry=None, k1_shape=(1, 1, 1), captures=0)
    host = [(0.0, 1000.0, trace.REQUEST_SPAN), (1000.0, 2000.0, trace.REQUEST_SPAN),
            *host]
    ran.program_trace = program_trace.ProgramTrace(
        slice=trace.Slice(device=[], host=host, requests=2), snapshot=snapshot)
    return ran


def test_the_fleet_readers_on_a_stubbed_snapshot_and_slice():
    host = [(10.0, 40.0, "frenetix.device_sim.fleet.load"),
            (1010.0, 1030.0, "frenetix.device_sim.fleet.load")]
    counters = {"device_sim.fleet.agent_cycles_real": 2 * 12_736,
                "device_sim.fleet.agent_cycles_stacked": 2 * 36_352}
    ran = _traced({"spans": {}, "counters": counters, "device_counters": {}}, host)
    assert metrics.load("fleet_row_fill").read(ran) == pytest.approx(35.035211267605634)
    assert metrics.load("fleet_load_ms").read(ran) == pytest.approx(0.025)


@pytest.mark.parametrize("name", ["fleet_row_fill", "fleet_load_ms"])
def test_the_fleet_readers_find_nothing_without_a_fleet(name):
    empty = _traced({"spans": {}, "counters": {"device_sim.cycles": 142},
                     "device_counters": {}})
    assert metrics.load(name).read(empty) is None
    bare = run.Run(entry=None, k1_shape=(1, 1, 1), captures=0, traced=[])
    assert metrics.load(name).read(bare) is None


def test_the_fleet_reference_check_and_generator_import_nothing_of_the_program():
    import json
    import subprocess
    import sys

    code = ("import json, sys\n"
            "import portbench.reference.fleet, portbench.checks.fleet_run\n"
            "import portbench.generators.fleet_run\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(spec.ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {"frenetix_tpu_torch", "frenetix_tpu", "jax", "jaxlib"} & top
