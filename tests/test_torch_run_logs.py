"""The user-facing run's logs: the port's `run_one` / CLI against the JAX
package's `run_one`, at float64 on the CPU.

- A short highway (written as CommonRoad XML, read by both packages) with
  logging, `debug.save_all_traj` and evaluation: every table of
  simulation.db and of the agent's trajectories.db, logs.csv and
  trajectories.csv are equal row for row, and the solution XML element for
  element.  Left out of the comparison: the wall-time columns
  (`global_performance_measure.total_sim_time`, the timing columns of
  `batch_performance_measure`, `meta.duration_init`, logs.csv's
  `calculation_time_s`).  "Equal": text and integers exactly; REAL columns
  within 1e-9 relative (1e-10 absolute); numbers printed at a fixed
  precision (the 5-significant-digit JSON arrays, the rounded logs.csv
  fields) within one unit of their last printed digit plus 1e-9 (absolute
  and relative: the f64 round-off of values that are zero in exact
  arithmetic prints as e.g. 3.6e-15); the XML's numbers,
  printed with 17 digits, within 1e-12 relative; the date stamp is not
  compared.  One class of candidate rows is compared by key only: candidates
  infeasible in both runs whose sampled end velocity is the sampler's floor
  of 0.001 m/s, exactly the rollout's standstill threshold (`s_vel > 0.001`):
  whether their extension counts as moving flips with the last bit of the
  polynomial, in both packages alike.  Their feasibility flags are equal.
- The port's device-resident run (`--device-sim`) writes the log set of the
  JAX package's device path: meta, the reference path, the evaluation and
  the solution XML, no per-step timing rows, no results rows and no
  per-cycle trajectory rows; its evaluation rows and solution states agree
  with the port's host run of the same scenario.
- A behavior run writes the behavior log under the agent's log directory,
  row for row as the JAX package's.
- `cuda`-marked twins run the CLI on the card against the CPU float64 run;
  they skip without a CUDA device.
"""
import csv
import logging
import os
import sqlite3
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from frenetix_tpu_torch import run_scenario
from frenetix_tpu_torch.io import commonroad_writer, scenario_factory

torch.set_num_threads(2)

# wall-time columns, per table
TIMING = {
    "global_performance_measure": {"total_sim_time", "global_sim_preprocessing",
                                   "global_batch_synchronization",
                                   "global_visualization"},
    "batch_performance_measure": {"process_iteration_time", "sim_step_time",
                                  "agent_planning_time", "sync_time_in", "sync_time_out"},
    "meta": {"duration_init"},
    "logs.csv": {"calculation_time_s"},
}
STANDSTILL = 0.001          # the sampler's velocity floor = the rollout's threshold
FAST = ["--set", "planning.sampling_min=1", "--set", "planning.sampling_max=2"]


def _short_highway(tmp_path, **kw):
    path = str(tmp_path / "hw.xml")
    commonroad_writer.write_scenario(
        scenario_factory.make_highway(length=100.0, n_steps=60, **kw), path)
    return path


def _tables(db):
    con = sqlite3.connect(db)
    names = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
    out = {}
    for t in names:
        cols = [c[1] for c in con.execute(f"PRAGMA table_info({t})")]
        out[t] = (cols, sorted(con.execute(f"SELECT * FROM {t}").fetchall(),
                               key=lambda r: tuple(str(v) for v in r[:3])))
    con.close()
    return out


def _decimals(s):
    s = s.strip()
    if "e" in s.lower():
        mant, exp = s.lower().split("e")
        d = len(mant.split(".")[1]) if "." in mant else 0
        return d - int(exp)
    return len(s.split(".")[1]) if "." in s else 0


def _same_printed(a: str, b: str) -> bool:
    """Two numbers printed at a fixed precision: within one unit of the
    last printed digit, plus 1e-9 relative and 1e-9 absolute (round-off of
    values that are zero in exact arithmetic prints as e.g. 3.6e-15)."""
    x, y = float(a), float(b)
    if x == y:
        return True
    tol = 10.0 ** -min(_decimals(a), _decimals(b)) + 1e-9 * abs(x) + 1e-9
    return abs(x - y) <= tol


def _same_field(a, b) -> bool:
    if a == b:
        return True
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-9 * abs(a) + 1e-10
    if isinstance(a, str) and isinstance(b, str):
        if a.startswith("[") and b.startswith("["):
            xa, xb = a[1:-1].split(","), b[1:-1].split(",")
            return len(xa) == len(xb) and all(_same_printed(x, y) for x, y in zip(xa, xb))
        try:
            return _same_printed(a, b)
        except ValueError:
            return False
    return False


def _knife_edge(db):
    """(time_step, id) of the candidates infeasible with their end velocity
    at the standstill threshold."""
    t = _tables(db)
    if "sampling_params" not in t:
        return set()
    cols, rows = t["sampling_params"]
    ss1 = cols.index("ss1")
    feas = {r[:2]: r[2] for r in t["infeasability"][1]}
    return {r[:2] for r in rows if r[ss1] == STANDSTILL and feas.get(r[:2]) == 0}


def assert_db_equal(want_db, got_db, exempt=frozenset(), skip_rows=()):
    want, got = _tables(want_db), _tables(got_db)
    assert list(got) == list(want), got_db
    for t, (cols, rows) in want.items():
        gcols, grows = got[t]
        assert gcols == cols, t
        assert len(grows) == len(rows), t
        skip = TIMING.get(t, set())
        for rw, rg in zip(rows, grows):
            assert rw[:2] == rg[:2], t
            if t in skip_rows and rw[:2] in exempt:
                continue
            for c, a, b in zip(cols, rw, rg):
                if c not in skip:
                    assert _same_field(a, b), (t, c, rw[:2], a, b)


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=";"))


def assert_csv_equal(want, got, skip_cols=(), exempt=frozenset()):
    rw, rg = _csv_rows(want), _csv_rows(got)
    assert rg[0] == rw[0] and len(rg) == len(rw), got
    head = rw[0]
    for a, b in zip(rw[1:], rg[1:]):
        assert len(a) == len(b)
        key = (int(a[0]), int(a[1])) if exempt else None
        if key in exempt:
            assert a[:3] == b[:3]
            continue
        for c, x, y in zip(head, a, b):
            if c not in skip_cols:
                assert _same_field(x, y), (got, c, a[:2], x[:80], y[:80])


def assert_xml_equal(want, got, rtol=1e-12):
    a, b = ET.parse(want).getroot(), ET.parse(got).getroot()
    ea, eb = list(a.iter()), list(b.iter())
    assert [e.tag for e in ea] == [e.tag for e in eb]
    for x, y in zip(ea, eb):
        assert {k: v for k, v in x.attrib.items() if k != "date"} \
            == {k: v for k, v in y.attrib.items() if k != "date"}
        tx, ty = (x.text or "").strip(), (y.text or "").strip()
        if tx != ty:
            assert float(ty) == pytest.approx(float(tx), rel=rtol, abs=rtol), x.tag


# ------------------------------------------------ JAX run_one = port run_one


def test_run_one_logs_equal_jax(tmp_path, capsys):
    from frenetix_tpu.run_scenario import run_one as jax_run_one
    from frenetix_tpu.utils.config import load_config as jax_load_config

    xml = _short_highway(tmp_path)
    jdir, tlogs = tmp_path / "jax" / "hw", tmp_path / "torch"
    jcfg = jax_load_config(overrides={
        "dtype": "float64", "debug": {"save_all_traj": True},
        "planning": {"sampling_min": 1, "sampling_max": 2}}, strict_overrides=True)
    jres = jax_run_one(xml, jcfg, None, log_dir=str(jdir), evaluate=True)
    rc = run_scenario.main([xml, "--device", "cpu", "--set", "dtype=float64",
                            "--set", "debug.save_all_traj=true", *FAST,
                            "--evaluate", "--logs", str(tlogs)])
    assert rc == 0 and jres.success
    tdir = tlogs / "hw"
    files = sorted(os.path.relpath(os.path.join(r, f), jdir)
                   for r, _, fs in os.walk(jdir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), tdir)
                           for r, _, fs in os.walk(tdir) for f in fs)
    assert files == ["60000/logs.csv", "60000/trajectories.csv", "60000/trajectories.db",
                     "simulation.db", "solution_60000.xml"]

    assert_db_equal(str(jdir / "simulation.db"), str(tdir / "simulation.db"))
    sim = _tables(str(tdir / "simulation.db"))
    assert len(sim["results"][1]) == 1 and sim["results"][1][0][6] == "success"
    assert len(sim["scenario_evaluation"][1]) == len(jres.histories[60000])
    assert len(sim["global_performance_measure"][1]) == jres.steps

    edge = _knife_edge(str(jdir / "60000" / "trajectories.db"))
    assert edge == _knife_edge(str(tdir / "60000" / "trajectories.db"))
    assert_db_equal(str(jdir / "60000" / "trajectories.db"),
                    str(tdir / "60000" / "trajectories.db"),
                    exempt=edge, skip_rows=("trajectories", "costs"))
    traj = _tables(str(tdir / "60000" / "trajectories.db"))
    n_rows = len(traj["costs"][1])
    assert n_rows > 1000 and len(edge) < n_rows // 4
    assert_csv_equal(str(jdir / "60000" / "logs.csv"), str(tdir / "60000" / "logs.csv"),
                     skip_cols=TIMING["logs.csv"])
    assert_csv_equal(str(jdir / "60000" / "trajectories.csv"),
                     str(tdir / "60000" / "trajectories.csv"), exempt=edge)
    assert_xml_equal(str(jdir / "solution_60000.xml"), str(tdir / "solution_60000.xml"))
    out = capsys.readouterr().out
    assert "SYN_Highway-1 agent=60000 status=COMPLETED_SUCCESS" in out
    assert (tlogs / "score_overview.csv").exists()
    assert not (tlogs / "log_failures.csv").exists()
    # messages.log: the first main() of the process made the logger, later
    # ones write to its file
    logger = logging.getLogger("frenetix_tpu_torch")
    (fh,) = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    fh.flush()
    text = open(fh.baseFilename).read()
    assert f"solution written: {tdir / 'solution_60000.xml'}" in text


# ------------------------------------------- device run against host run


def test_device_sim_log_set_against_host_run(tmp_path, capsys):
    from frenetix_tpu_torch.parallel import device_sim

    xml = _short_highway(tmp_path)
    common = [xml, "--device", "cpu", "--set", "dtype=float64", *FAST, "--evaluate"]
    assert run_scenario.main([*common, "--logs", str(tmp_path / "host")]) == 0
    fetches = device_sim.FETCHES
    assert run_scenario.main([*common, "--device-sim", "--logs", str(tmp_path / "dev")]) == 0
    assert device_sim.FETCHES == fetches + 1          # one fetch for the run
    host, dev = tmp_path / "host" / "hw", tmp_path / "dev" / "hw"
    for rel in ("simulation.db", "60000/trajectories.db", "60000/logs.csv",
                "solution_60000.xml"):
        assert (dev / rel).exists(), rel
    assert not (tmp_path / "dev" / "log_failures.csv").exists()

    h, d = _tables(str(host / "simulation.db")), _tables(str(dev / "simulation.db"))
    assert list(h) == list(d)
    # the device path writes no per-step and no results rows (as the JAX
    # package's device path: Simulation.run, which writes them, is not run)
    for t in ("global_performance_measure", "batch_performance_measure", "results"):
        assert h[t][1] and not d[t][1], t
    meta_cols = h["meta"][0]
    skip = meta_cols.index("duration_init")
    assert [v for i, v in enumerate(h["meta"][1][0]) if i != skip] \
        == [v for i, v in enumerate(d["meta"][1][0]) if i != skip]
    cols, hrows = h["scenario_evaluation"]
    drows = d["scenario_evaluation"][1]
    assert [r[:4] for r in hrows] == [r[:4] for r in drows]
    hv = np.array([[np.nan if v is None else v for v in r[4:]] for r in hrows], float)
    dv = np.array([[np.nan if v is None else v for v in r[4:]] for r in drows], float)
    np.testing.assert_allclose(dv, hv, rtol=1e-6, atol=1e-6, equal_nan=True)

    ht, dt = _tables(str(host / "60000" / "trajectories.db")), \
        _tables(str(dev / "60000" / "trajectories.db"))
    assert ht["reference_path"] == dt["reference_path"] and ht["meta"] == dt["meta"]
    for t in ("trajectories", "costs", "sampling_params", "trajectories_meta"):
        assert ht[t][1] and not dt[t][1], t
    assert len(_csv_rows(dev / "60000" / "logs.csv")) == 1        # the header

    def states(path):
        root = ET.parse(path).getroot()
        return np.array([[float(s.find(p).text) for p in
                          ("time/exact", "position/point/x", "position/point/y",
                           "orientation/exact", "velocity/exact")]
                         for s in root.iter("ksState")])

    np.testing.assert_allclose(states(dev / "solution_60000.xml"),
                               states(host / "solution_60000.xml"), rtol=0, atol=1e-9)
    capsys.readouterr()


# --------------------------------------------------------- behavior log


def test_behavior_log_equals_jax(tmp_path):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.sim import Simulation as JSimulation
    from frenetix_tpu.utils.config import load_config as jax_load_config
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils.config import load_config

    short = dict(length=110.0, stop_at=50.0, red_steps=40, n_steps=120)
    ov = {"dtype": "float64", "behavior": {"use_behavior_planner": True},
          "planning": {"sampling_min": 1, "sampling_max": 2}}
    jres = JSimulation(jfactory.make_traffic_light(**short),
                       jax_load_config(overrides=ov), log_dir=str(tmp_path / "j")).run()
    tres = Simulation(scenario_factory.make_traffic_light(**short), load_config(overrides=ov),
                      torch.device("cpu"), log_dir=str(tmp_path / "t")).run()
    assert tres.steps == jres.steps and tres.success == jres.success
    rows = _csv_rows(tmp_path / "t" / "60000" / "behavior_log.csv")
    assert len(rows) > 30 and rows[0][0] == "time_step"
    # the light is met: prepare, stop, go on green
    assert {r[2] for r in rows[1:]} >= {"PrepareTrafficLight", "TrafficLight"}
    assert {r[3] for r in rows[1:]} >= {"Stopping", "GreenLight"}
    assert_csv_equal(str(tmp_path / "j" / "60000" / "behavior_log.csv"),
                     str(tmp_path / "t" / "60000" / "behavior_log.csv"))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cli_highway_evaluate_on_card(cuda_device, tmp_path):
    """(a) of chip_smoke phase 15: the card's float32 run writes the same
    table set and row counts as the CPU float64 run, with equal statuses."""
    xml = _short_highway(tmp_path)
    assert run_scenario.main([xml, "--evaluate", "--logs", str(tmp_path / "card")]) == 0
    assert run_scenario.main([xml, "--evaluate", "--device", "cpu", "--set",
                              "dtype=float64", "--logs", str(tmp_path / "cpu")]) == 0
    card, cpu = _tables(str(tmp_path / "card" / "hw" / "simulation.db")), \
        _tables(str(tmp_path / "cpu" / "hw" / "simulation.db"))
    assert list(card) == list(cpu)
    assert {t: len(r) for t, (_, r) in card.items()} == {t: len(r) for t, (_, r) in cpu.items()}
    assert card["results"][1][0][3:5] == cpu["results"][1][0][3:5]
    assert (tmp_path / "card" / "hw" / "solution_60000.xml").exists()


@pytest.mark.cuda
def test_cli_device_sim_evaluate_on_card(cuda_device, tmp_path):
    """(c) of chip_smoke phase 15: the two-agent highway as one device run
    with one fetch, evaluated; the JAX device path's log set."""
    from frenetix_tpu_torch.parallel import device_sim

    fetches = device_sim.FETCHES
    assert run_scenario.main(["highway", "--multiagent", "--device-sim", "--evaluate",
                              "--logs", str(tmp_path)]) == 0
    assert device_sim.FETCHES == fetches + 1
    t = _tables(str(tmp_path / "highway" / "simulation.db"))
    assert not t["results"][1] and t["scenario_evaluation"][1]
    assert len({r[1] for r in t["scenario_evaluation"][1]}) == 2
