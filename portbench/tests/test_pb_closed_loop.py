"""The harness's extension points: a closed-loop configuration (a generator,
an entry of many cycles per request and a check of its own, with a number
of its own in its limits file) added to a copy of the benchmark by new
files and entries alone; a transition fault planted under it comes out not
correct; a limits file that names a number its comparison does not compute
is refused; and the cells without those keys read what `judge.compare`
reads, one cycle and `agents × candidates_per_agent` candidates per
request."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from portbench import e2e, entries, generate, judge, run, spec
from portbench.tests.conftest import tiny

ROOT = spec.ROOT
CYCLES = 3

GENERATOR = '''
"""A closed loop of the convoy: each request is a scenario whose agents
plan `cycles` times, `replanning_steps` steps apart, among obstacles that
keep their lane and speed.  `draw_pool` draws the agents' first state and
the obstacles' ground truth over the whole run; `cycle_request` is the
request of one cycle from the agents' state at its start."""
import numpy as np

from portbench import generate


def draw_pool(config, mix, seed):
    steps = config["prediction_steps"] + config["cycles"] * config["replanning_steps"]
    return generate.draw_pool(dict(config, prediction_steps=steps), mix, seed)


def first_state(req):
    """(A, 7): s, s_dot, s_ddot, d, d_dot, d_ddot, orientation."""
    return np.column_stack([req["x0_lon"], req["x0_lat"], req["x0_orientation"]])


def cycle_request(config, req, c, state):
    t0, t_n = c * config["replanning_steps"], config["prediction_steps"]
    out = dict(req)
    for key in ("means", "orientations", "velocities", "valid", "covs", "inv_covs"):
        out[key] = req[key][:, :, t0:t0 + t_n]
    out["obstacle_xy"] = out["means"][:, :, 0].copy()
    out["obstacle_valid"] = out["valid"][:, :, 0].copy()
    out["x0_lon"], out["x0_lat"] = state[:, 0:3], state[:, 3:6]
    out["x0_orientation"] = state[:, 6]
    return out
'''

ENTRY = '''
"""`cycles` batched cycles per request, each from the state the last one
selected, after `replanning_steps` steps of its trajectory."""
import numpy as np

from portbench.entries import batched_cycle
from portbench.generators import closed_loop


class Entry(batched_cycle.Entry):
    def __init__(self, config, lines, device, tracing=False):
        super().__init__(config, lines, device, tracing)
        self.cycles = config["cycles"]
        self.candidates = self.cycles * config["agents"] * config["candidates_per_agent"]

    def prepare(self, req):
        return req

    def next_state(self, cycle_answer):
        rows = cycle_answer["rows"][:, :, self.config["replanning_steps"]]
        return rows[:, [6, 7, 8, 9, 10, 11, 2]]

    def request(self, req):
        state, flats, states = closed_loop.first_state(req), [], []
        for c in range(self.cycles):
            states.append(state)
            cyc = closed_loop.cycle_request(self.config, req, c, state)
            flats.append(super().request(super().prepare(cyc)))
            state = self.next_state(super().answer(flats[-1]))
        return np.stack(flats), np.stack(states)

    def answer(self, packed):
        flats, states = packed
        cycles = [super(Entry, self).answer(f) for f in flats]
        return dict(found=np.stack([a["found"] for a in cycles]), cycles=cycles,
                    states=states)
'''

CHECK = '''
"""Each cycle of a closed-loop answer, teacher-forced: the cycle's request
is rebuilt from the state the program reported at its start and held to
the reference as `judge.compare` holds one cycle; and `transition_m`, the
widest gap of s and d between the state the program reported at cycle
c + 1 and the reference's rollout of the program's pick at c after
`replanning_steps` steps."""
import numpy as np

from portbench import judge, reference
from portbench.generators import closed_loop

NUMBERS = ("found_mismatch", "pick_gap", "traj_err_m", "cost_err_rel", "hist_diff",
           "transition_m")


def compare(config, lines, request, answer, *, device):
    k = config["replanning_steps"]
    numbers = dict.fromkeys(NUMBERS, 0.0)
    states = answer["states"]
    for c, got in enumerate(answer["cycles"]):
        req = closed_loop.cycle_request(config, request, c, states[c])
        one = judge.compare(config, lines, [(req, got)], device=device)
        judge.fold(numbers, {n: v for n, v in one.items() if n in NUMBERS})
        if c + 1 == len(states):
            continue
        ref = reference.solve(config, lines, req, device=device)
        for a in range(config["agents"]):
            if ref["found"][a]:
                want = ref["rows"][a][[6, 9], int(got["best"][a]), k].cpu().numpy()
                gap = np.abs(states[c + 1][a, [0, 3]] - want).max()
                numbers["transition_m"] = max(numbers["transition_m"], float(gap))
    return numbers
'''

RUN = '''
import json, sys, torch
from portbench import run
torch.set_num_threads(2)
if sys.argv[1] == "shifted":
    from portbench.entries import closed_loop
    own = closed_loop.Entry.next_state
    def shifted(self, cycle_answer):
        state = own(self, cycle_answer)
        state[:, 0] += 0.5                   # half a metre further along s
        return state
    closed_loop.Entry.next_state = shifted
result, checks, window = run.run_cell("convoy8_loop.tiny", 2 ** 31 + 19, 0.3, False,
                                      torch.device("cpu"), setup_from=lambda: 0.0)
print(json.dumps({"result": result, "checks": checks, "cycles": window.cycles,
                  "candidates": window.candidates, "requests": len(window.latencies_s),
                  "seconds": window.seconds}))
'''


@pytest.fixture(scope="module")
def loop_copy(tmp_path_factory):
    """A copy of the benchmark with the closed loop added by new files and
    new entries of BENCHMARK.json only."""
    tmp = tmp_path_factory.mktemp("closed_loop")
    here = tmp / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "generators" / "closed_loop.py").write_text(GENERATOR)
    (here / "entries" / "closed_loop.py").write_text(ENTRY)
    (here / "checks" / "closed_loop.py").write_text(CHECK)
    config, mix = tiny("convoy8.plain")
    config.update(name="convoy8_loop", entry="closed_loop", generator="closed_loop",
                  check="closed_loop", cycles=CYCLES, replanning_steps=3,
                  check_requests=1)
    (here / "configs" / "convoy8_loop.json").write_text(json.dumps(config))
    lims = json.loads((here / "limits" / "convoy8.json").read_text())
    (here / "limits" / "convoy8_loop.json").write_text(
        json.dumps(dict(lims, transition_m=1e-2)))
    (here / "traffic" / "near_tiny.json").write_text(json.dumps(mix))
    bench = spec.load()
    bench["configs"].append({"name": "convoy8_loop", "source": "test",
                             "file": "portbench/configs/convoy8_loop.json", "reduced": [],
                             "why": "a closed loop"})
    bench["workloads"].append({"name": "convoy8_loop.tiny", "config": "convoy8_loop",
                               "traffic": "near_tiny", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("cycle_ms_p95.risk", "cand_evals_per_s.risk"):
            m["workloads"].append("convoy8_loop.tiny")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, config


def _run_loop(tmp, mode):
    env = {"PYTHONPATH": f"{tmp}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN), mode], cwd=tmp,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_closed_loop_from_files_alone(loop_copy):
    tmp, config = loop_copy
    got = _run_loop(tmp, "plain")
    result = got["result"]
    assert result["correct"], got["checks"]
    assert result["failed"] == 0
    assert [name for name, _, _ in got["checks"]][-1] == "transition_m"
    assert got["cycles"] == CYCLES
    per_request = CYCLES * config["agents"] * config["candidates_per_agent"]
    assert got["candidates"] == per_request
    rate = result["metrics"]["cand_evals_per_s.risk"]["value"]
    assert rate == pytest.approx(per_request * got["requests"] / got["seconds"])
    assert set(result["metrics"]) == {"setup_s", "cycle_ms_p95.risk",
                                      "cand_evals_per_s.risk"}
    assert not (ROOT / "portbench" / "checks" / "closed_loop.py").exists()


def test_closed_loop_transition_fault_is_not_correct(loop_copy):
    tmp, _ = loop_copy
    got = _run_loop(tmp, "shifted")
    numbers = {name: (value, limit) for name, value, limit in got["checks"]}
    assert not got["result"]["correct"]
    assert got["result"]["failed"] > 0
    assert numbers["transition_m"][0] > numbers["transition_m"][1]
    assert all(v <= lim for name, (v, lim) in numbers.items() if name != "transition_m")


@pytest.mark.parametrize("config_name,key", [
    ("ego_dense", "bogus"), ("convoy8", "resp_err_rel_max"), ("convoy8_risk", "transition_m"),
])
def test_a_limit_the_comparison_does_not_compute_raises(config_name, key, tmp_path,
                                                        monkeypatch):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE / "limits", here / "limits")
    shutil.copytree(spec.HERE / "configs", here / "configs")
    path = here / "limits" / f"{config_name}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **{key: 1.0})))
    monkeypatch.setattr(judge, "__file__", str(here / "judge.py"))
    with pytest.raises(ValueError, match=key):
        judge.limits(config_name)


def test_a_check_that_omits_a_number_raises(monkeypatch):
    check = types.SimpleNamespace(NUMBERS=("found_mismatch", "transition_m"),
                                  compare=lambda *a, **k: {"found_mismatch": 0.0})
    monkeypatch.setattr(judge, "check_of", lambda config: check)
    with pytest.raises(ValueError, match="transition_m"):
        judge.compare_one({"check": "x"}, None, None, None, device=None)


@pytest.mark.parametrize("workload", ("ego_dense.sweep", "convoy8_risk.near",
                                      "convoy8.plain"))
def test_cells_without_the_keys_read_what_judge_compare_reads(workload, cpu, monkeypatch):
    """A whole run's numbers equal `judge.compare` over the same sampled
    answers, folded as the parent's run folded them; one cycle and
    agents × candidates per request."""
    made = []
    load = entries.load

    def recording(name):
        module = load(name)

        class Recorded(module.Entry):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)
        return types.SimpleNamespace(Entry=Recorded)

    monkeypatch.setattr(entries, "load", recording)
    config, mix = tiny(workload)
    seed = 2 ** 32 + 3
    result, checks, window = run.run_cell(workload, seed, 0.3, False, cpu, config=config,
                                          mix=mix, setup_from=lambda: 0.0)
    assert "generator" not in config and "check" not in config
    assert window.cycles == 1
    assert window.candidates == config["agents"] * config["candidates_per_agent"]
    lat = np.asarray(window.latencies_s) * 1e3
    assert e2e.cycle_ms_p95(window) == float(np.percentile(lat, 95))
    lines, pool = generate.draw_pool(config, mix, seed)
    lines_run, pool_run = generate.pool_of(config, mix, seed)
    assert np.array_equal(lines, lines_run)
    numbers = dict.fromkeys(judge.NUMBERS, 0.0)
    for k in judge.sample(len(window.answers), config["check_requests"], seed):
        got = judge.compare(config, lines, [(pool[k % len(pool)],
                                             made[0].answer(window.answers[k]))],
                            device=cpu)
        for name, v in got.items():
            numbers[name] = (numbers[name] + v if name == "found_mismatch"
                             else max(numbers[name], v))
    lims = json.loads((spec.HERE / "limits" / f"{config['name']}.json").read_text())
    assert checks == [(k, numbers[k], float(lims[k])) for k in judge.NUMBERS if k in lims]
    assert result["correct"]
