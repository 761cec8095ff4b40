"""BENCHMARK.json against the contract's form, every name it gives found as
a file, and a cell, a configuration and a metric added from files and
entries alone."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from portbench import e2e, entries, judge, metrics, spec

ROOT = spec.ROOT
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def test_keys_and_limits_of_the_file():
    bench = spec.load()
    assert set(bench) == KEYS
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert e2e.function(m["name"])
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names and set(m["workloads"]) <= cells
        for w in m["workloads"]:                 # each listed cell reports `moves`
            assert m["moves"] in [e["name"] for e in
                                  spec.metrics_of(bench, w, "end_to_end")], (m, w)
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = spec.metrics_of(bench, w["name"], "per_layer")
        assert reported and len(spec.metrics_of(bench, w["name"], "end_to_end")) >= 2
    for c in bench["configs"]:                   # the optional keys, and the limits
        config = spec.config(c["name"])
        for key in ("generator", "check"):
            assert config.get(key) is None or spec.NAME.match(config[key])
        lims = judge.limits(c["name"])             # raises on a number not computed
        assert list(lims) == [n for n in judge.numbers_of(config) if n in lims] != []


@pytest.mark.parametrize("name,ok", [
    ("ego_dense.sweep", True), ("_x-1", True), ("a" * 64, True), ("a" * 65, False),
    ("two words", False), ("a/b", False), ("a,b", False), (".hidden", False),
    ("µs", False),
])
def test_name_characters(name, ok):
    assert bool(spec.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("evals/s", True), ("%", True), ("count", True), ("ms", True),
    ("evals per s", False), ("µs", False), ("a" * 17, False),
])
def test_unit_characters(unit, ok):
    assert bool(spec.UNIT.match(unit)) is ok


def test_every_name_is_a_file():
    bench = spec.load()
    assert spec.bad_names(bench) == []
    for c in bench["configs"]:
        config = spec.config(c["name"])
        assert (ROOT / c["file"]).is_file() and config["name"] == c["name"]
        assert config["reduced"] == c["reduced"] == []
        assert entries.load(config["entry"]).Entry
        assert (spec.HERE / "limits" / f"{c['name']}.json").is_file()
        if "generator" in config:
            assert (spec.HERE / "generators" / f"{config['generator']}.py").is_file()
        if "check" in config:
            assert (spec.HERE / "checks" / f"{config['check']}.py").is_file()
            check = judge.check_of(config)
            assert check.NUMBERS and callable(check.compare)
    for w in bench["workloads"]:
        assert spec.traffic(w["traffic"])["pool_requests"] > 0
    for m in bench["per_layer"]:
        assert callable(metrics.load(m["name"]).read)


NEW_READER = '''
"""Host layer: the mean host time of a traced request, in ms."""
from portbench import trace


def read(run):
    if run.slice is None:
        return None
    spans = [e - s for s, e, n in run.slice.host if n == trace.REQUEST_SPAN]
    return sum(spans) / len(spans) * 1e-3 if spans else None
'''


def test_cell_config_and_metric_from_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, limits,
    a cell and a per-layer metric by new files and new entries only, and a
    traced run of the new cell reports the new metric."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load()
    here = tmp_path / "portbench"
    config = spec.config("ego_dense")
    config.update(name="ego_small", candidates_per_agent=240, check_requests=2,
                  warmup_requests=1, trace_after_requests=0, trace_requests=2)
    config["sampling"].update(bucket=256)
    config["sampling"]["velocity"]["level"] = 1
    config["sampling"]["lateral"]["level"] = 1
    (here / "configs" / "ego_small.json").write_text(json.dumps(config))
    (here / "limits" / "ego_small.json").write_text(
        (here / "limits" / "ego_dense.json").read_text())
    mix = spec.traffic("sweep")
    mix.update(pool_requests=3)
    (here / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (here / "metrics" / "host_request_ms.py").write_text(NEW_READER)
    bench["configs"].append({"name": "ego_small", "source": "test",
                             "file": "portbench/configs/ego_small.json", "reduced": [],
                             "why": "a small copy"})
    bench["workloads"].append({"name": "ego_small.tiny", "config": "ego_small",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "cycle_ms_p95")["workloads"].append("ego_small.tiny")
    bench["per_layer"].append({"name": "host_request_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "Entry", "moves": "cycle_ms_p95",
                               "workloads": ["ego_small.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import json, torch
        from portbench import run
        torch.set_num_threads(2)
        result, _, _ = run.run_cell("ego_small.tiny", 5, 0.2, True, torch.device("cpu"),
                                    setup_from=lambda: 0.0)
        print(json.dumps(result))
    """)
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["host_request_ms"]["value"] > 0.0
    assert "graph_captures" not in result["metrics"]
    assert not (Path(ROOT) / "portbench" / "configs" / "ego_small.json").exists()
