"""The port's config surface and CLI flags against the JAX package's.

- `ops.vehicle_db.resolve_vehicle` against the JAX one on the cases of
  `tests/test_vehicle_db.py` (exact: the same constants and arithmetic),
  and `vehicle.cr_vehicle_id` through `load_config`.
- `parse_cli_overrides` against the JAX one (which resolves values with
  `yaml.safe_load`) on ints, floats, bools, null, strings, flow lists and
  dotted keys; where the port's `_yaml_scalar` does not build a form it
  raises ValueError (never a string where PyYAML builds another type).
- Every key of every JAX config section loads in the port, strictly, as a
  `--set` key would.
- The planner-interface registry: the default interface, a registered
  custom one driving an agent's replans, and the JAX package's error for an
  unknown name.
- `--plot` / `--gif` / `visualization.show_plots` fail with slice 8e's
  NotImplementedError; through the CLI the failure goes to
  log_failures.csv with its traceback and the exit code is 1.
- `--set` through `main`: strict keys, the vehicle database, the
  replanning frequency.
"""
import csv
import dataclasses

import pytest
import torch

from frenetix_tpu_torch import run_scenario
from frenetix_tpu_torch.ops.vehicle_db import VEHICLE_DB, resolve_vehicle
from frenetix_tpu_torch.utils import config as tconfig

CPU = torch.device("cpu")

# --------------------------------------------------------- vehicle database


@pytest.mark.parametrize("vid, overrides", [
    (1, None), (2, None), (3, None),
    (2, {"mass": 1475.0, "v_max": None}),
    (2, {"wheelbase": 2.9}),
    (3, {"a_max": 8.0, "wb_front_axle": 1.2}),
    ("1", {"length": 4.0}),
])
def test_resolve_vehicle_matches_jax(vid, overrides):
    from frenetix_tpu.ops.vehicle_db import resolve_vehicle as jresolve

    want = jresolve(vid, dict(overrides) if overrides else overrides)
    got = resolve_vehicle(vid, dict(overrides) if overrides else overrides)
    assert got._fields == want._fields
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("vid, overrides", [(7, None), (2, {"no_such_field": 1.0})])
def test_resolve_vehicle_refuses_as_jax(vid, overrides):
    from frenetix_tpu.ops.vehicle_db import resolve_vehicle as jresolve

    with pytest.raises(ValueError):
        jresolve(vid, overrides)
    with pytest.raises(ValueError):
        resolve_vehicle(vid, overrides)


def test_vehicle_db_equals_jax():
    from frenetix_tpu.ops.vehicle_db import VEHICLE_DB as JDB

    assert VEHICLE_DB == JDB


@pytest.mark.parametrize("vehicle", [
    {}, {"cr_vehicle_id": 1}, {"cr_vehicle_id": 2},
    {"cr_vehicle_id": 3, "a_max": 8.0}, {"cr_vehicle_id": None, "length": 5.0},
    {"cr_vehicle_id": 2, "wb_front_axle": 1.0, "mass": None},
])
def test_cr_vehicle_id_through_load_config_matches_jax(vehicle):
    from frenetix_tpu.utils.config import load_config as jload

    ov = {"vehicle": vehicle}
    want = jload(overrides=ov, strict_overrides=True).vehicle
    got = tconfig.load_config(overrides=ov, strict_overrides=True).vehicle
    assert tuple(got) == tuple(want)


# ------------------------------------------------------------ --set parser


_SET_ITEMS = [
    "planning.replanning_frequency=1", "a.b.c=-3", "x=+7", "x=0x1f", "x=017",
    "x=1_000", "x=0.5", "x=-1.25e+3", "x=1e3", "x=.inf", "x=-.inf", "x=.5",
    "x=true", "x=False", "x=yes", "x=off", "x=null", "x=~", "x=", "x=NULL",
    "prediction.mode=ground_truth", "x=min_risk", "x=a=b", "x= 12 ",
    "x='quoted: yes'", 'x="007"', "x=[1, 2.5, true, null, abc]", "x=[]",
    "cost_weights.prediction=0.5", "vehicle.cr_vehicle_id=2",
]


@pytest.mark.parametrize("item", _SET_ITEMS)
def test_parse_cli_overrides_matches_jax(item):
    from frenetix_tpu.utils.config import parse_cli_overrides as jparse

    want, got = jparse([item]), tconfig.parse_cli_overrides([item])
    assert got == want
    assert type(_leaf(got)) is type(_leaf(want))


def _leaf(d):
    while isinstance(d, dict):
        d = next(iter(d.values()))
    return d


def test_parse_cli_overrides_merges_dotted_keys_as_jax():
    from frenetix_tpu.utils.config import parse_cli_overrides as jparse

    items = ["planning.dt=0.2", "planning.sampling_max=4", "debug.log_risk=true",
             "cost_weights.prediction=0.5", "cost_weights.jerk=1"]
    assert tconfig.parse_cli_overrides(items) == jparse(items)


@pytest.mark.parametrize("item", ["x={a: 1}", "x=1:30", "x=2024-01-01", "x=a: b",
                                  "x=&anchor", "x=[1, [2]]", "x=a #comment"])
def test_parse_cli_overrides_refuses_what_it_cannot_build(item):
    from frenetix_tpu.utils.config import parse_cli_overrides as jparse

    jparse([item])             # PyYAML builds something else than a string
    with pytest.raises(ValueError):
        tconfig.parse_cli_overrides([item])


def test_parse_cli_overrides_needs_key_value():
    with pytest.raises(ValueError, match="KEY=VALUE"):
        tconfig.parse_cli_overrides(["planning.dt"])


# --------------------------------------------------- every JAX key loads


def _jax_keys():
    """(section, field, default) of every dataclass section of the JAX
    config, the vehicle parameters and the dict fields' known keys."""
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    jcfg = JConfig()
    out = []
    for f in dataclasses.fields(jcfg):
        cur = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(cur):
            out += [(f.name, g.name, getattr(cur, g.name))
                    for g in dataclasses.fields(cur)]
        elif hasattr(cur, "_fields"):
            out += [(f.name, k, v) for k, v in zip(cur._fields, cur)]
            out += [(f.name, "cr_vehicle_id", None), (f.name, "wb_front_axle", 1.156)]
        elif isinstance(cur, dict):
            out += [(f.name, k, v) for k, v in cur.items()]
        else:
            out.append((None, f.name, cur))
    return out


def test_every_jax_config_key_loads_strictly():
    keys = _jax_keys()
    assert len(keys) > 120
    for section, key, value in keys:
        ov = {key: value} if section is None else {section: {key: value}}
        cfg = tconfig.load_config(overrides=ov, strict_overrides=True)
        assert cfg is not None, (section, key)
    # and as --set items
    items = [f"{key}={value}" if section is None else f"{section}.{key}=1"
             for section, key, value in keys
             if section not in ("vehicle",) and not isinstance(value, (dict, list, str))
             and value is not None]
    tconfig.load_config(overrides=tconfig.parse_cli_overrides(items),
                        strict_overrides=True)


def test_config_sections_equal_jax_field_for_field():
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    jcfg, tcfg = JConfig(), tconfig.FrenetixConfig()
    assert ([f.name for f in dataclasses.fields(tcfg)]
            == [f.name for f in dataclasses.fields(jcfg)])
    for section in ("debug", "simulation", "evaluation", "visualization"):
        jsec, tsec = getattr(jcfg, section), getattr(tcfg, section)
        assert ([f.name for f in dataclasses.fields(tsec)]
                == [f.name for f in dataclasses.fields(jsec)]), section
        assert dataclasses.asdict(tsec) == dataclasses.asdict(jsec), section


def test_unknown_metric_toggle_is_refused():
    with pytest.raises(ValueError, match="unknown"):
        tconfig.load_config(overrides={"evaluation": {"criticality_metrics": {"ttcc": True}}},
                            strict_overrides=True)
    cfg = tconfig.load_config(overrides={"evaluation": {"criticality_metrics": {"tit": False}}},
                              strict_overrides=True)
    assert cfg.evaluation.criticality_metrics == {"tit": False}


# ---------------------------------------------------------------- registry


def test_planner_interface_registry():
    from frenetix_tpu.sim import planner_interfaces as jpi
    from frenetix_tpu_torch.sim import planner_interfaces as tpi

    assert set(tpi.PLANNER_INTERFACES) == set(jpi.PLANNER_INTERFACES) \
        == {"FrenetPlannerInterface"}
    assert tpi.get_planner_interface("FrenetPlannerInterface") is tpi.FrenetPlannerInterface
    with pytest.raises(KeyError) as terr:
        tpi.get_planner_interface("NoSuchInterface")
    with pytest.raises(KeyError) as jerr:
        jpi.get_planner_interface("NoSuchInterface")
    assert str(terr.value) == str(jerr.value)


def test_registered_interface_drives_the_agent():
    from frenetix_tpu_torch.io.scenario_factory import make_highway
    from frenetix_tpu_torch.sim import planner_interfaces as tpi
    from frenetix_tpu_torch.sim.simulation import Simulation

    calls = []

    @tpi.register_planner_interface
    class CountingInterface(tpi.FrenetPlannerInterface):
        def step_interface(self):
            calls.append(self.agent.state.time_step)
            return super().step_interface()

    try:
        cfg = tconfig.load_config(overrides={
            "dtype": "float64",
            "planning": {"sampling_min": 1, "sampling_max": 2},
            "simulation": {"used_planner_interface": "CountingInterface"}},
            strict_overrides=True)
        sim = Simulation(make_highway(length=80.0, n_steps=20), cfg, CPU)
        assert type(sim.agents[0].interface).__name__ == "CountingInterface"
        res = sim.run()
    finally:
        del tpi.PLANNER_INTERFACES["CountingInterface"]
    assert calls and calls == [0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30, 33][:len(calls)]
    assert len(res.planning_times) == len(calls)
    cfg.simulation.used_planner_interface = "CountingInterface"
    with pytest.raises(KeyError, match="unknown planner interface"):
        Simulation(make_highway(), cfg, CPU)


# ------------------------------------------------------------------- plots


@pytest.mark.parametrize("vis", [{"save_plots": True}, {"show_plots": True},
                                 {"save_plots": True, "save_gif": True}])
def test_plots_raise_slice_8e(vis):
    from frenetix_tpu_torch.io.scenario_factory import make_highway
    from frenetix_tpu_torch.sim.simulation import Simulation

    cfg = tconfig.load_config(overrides={"visualization": vis}, strict_overrides=True)
    with pytest.raises(NotImplementedError, match="slice 8e"):
        Simulation(make_highway(), cfg, CPU)


@pytest.mark.parametrize("flag", ["--plot", "--gif"])
def test_cli_plot_fails_with_slice_8e(tmp_path, capsys, flag):
    logs = tmp_path / "logs"
    rc = run_scenario.main(["highway", "--device", "cpu", flag, "--logs", str(logs)])
    assert rc == 1
    rows = list(csv.reader(open(logs / "log_failures.csv"), delimiter=";"))
    assert len(rows) == 1 and rows[0][0] == "highway"
    assert "NotImplementedError" in rows[0][1] and "slice 8e" in rows[0][1]
    assert "Traceback" in rows[0][2]
    assert "status=" not in capsys.readouterr().out
    assert not (logs / "score_overview.csv").exists()


# --------------------------------------------------------- --set via main


def _captured_config(monkeypatch, argv):
    seen = {}

    def capture(targets, config, device, **kw):
        seen.update(targets=targets, config=config, device=device, kw=kw)
        return []

    monkeypatch.setattr(run_scenario, "run_scenarios", capture)
    assert run_scenario.main(argv) == 0
    return seen


def test_cli_set_resolves_vehicle_and_options(tmp_path, monkeypatch):
    seen = _captured_config(monkeypatch, [
        "highway", "--device", "cpu", "--logs", str(tmp_path),
        "--set", "vehicle.cr_vehicle_id=2",
        "--set", "planning.replanning_frequency=1", "--set", "dtype=float64",
        "--set", "simulation.start_multiagent=true", "--prediction", "constant_velocity",
        "--evaluate", "--no-logging"])
    cfg = seen["config"]
    assert tuple(cfg.vehicle) == tuple(resolve_vehicle(2))
    assert cfg.vehicle.mass == 1093.295 and cfg.vehicle.delta_max == 1.066
    assert cfg.planning.replanning_frequency == 1 and cfg.dtype == "float64"
    assert cfg.simulation.start_multiagent and cfg.prediction.mode == "constant_velocity"
    assert seen["device"] == CPU
    assert seen["kw"]["evaluate"] and seen["kw"]["no_logging"]
    assert seen["kw"]["logs"] == str(tmp_path)


def test_cli_flag_does_not_clobber_set(tmp_path, monkeypatch):
    seen = _captured_config(monkeypatch, [
        "highway", "--device", "cpu", "--logs", str(tmp_path),
        "--set", "simulation.batched_device_agents=true"])
    assert seen["config"].simulation.batched_device_agents


def test_cli_unknown_set_key_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown config override"):
        run_scenario.main(["highway", "--device", "cpu", "--logs", str(tmp_path),
                           "--set", "planning.no_such_key=1"])


def test_cli_replanning_frequency_changes_the_cycle_count(tmp_path, capsys):
    """`--set planning.replanning_frequency=1` replans every step."""
    from frenetix_tpu_torch.io import scenario_factory

    counts = {}
    for k in (3, 1):
        out = tmp_path / f"k{k}"
        rc = run_scenario.main([
            "highway", "--device", "cpu", "--logs", str(out),
            "--set", "planning.sampling_min=1", "--set", "planning.sampling_max=2",
            "--set", f"planning.replanning_frequency={k}",
            "--set", "simulation.max_steps_factor=0.15"])
        assert rc == 1        # the run is cut short: time limit
        rows = (out / "highway" / "60000" / "logs.csv").read_text().splitlines()
        counts[k] = len(rows) - 1
    steps = int(scenario_factory.make_highway().max_time_step * 0.15)
    assert counts == {3: -(-steps // 3), 1: steps}
    capsys.readouterr()
