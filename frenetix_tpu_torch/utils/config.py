"""Configuration of the port: typed dataclasses + optional YAML-directory merge.

A JAX-free copy of `frenetix_tpu/utils/config.py` (the JAX module imports
`VehicleParams` from a JAX module, so it cannot be imported where JAX is
absent).  Every section and field of the JAX package's config is carried,
with the same names and defaults; the tests pin that.  The flags of features
the port does not carry yet are among them, so that the simulation can
refuse them loudly.  `vehicle.cr_vehicle_id` resolves the vehicle from the
CommonRoad vehicle-model database (`ops/vehicle_db.py`); `--set KEY=VALUE`
overrides parse with `parse_cli_overrides`, which needs no PyYAML.
"""
from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Optional

from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.ops.vehicle_db import resolve_vehicle

__all__ = [
    "BehaviorConfig",
    "DebugConfig",
    "DEFAULT_COST_WEIGHTS",
    "EvaluationConfig",
    "EXTERNAL_COST_KEYS",
    "FrenetixConfig",
    "OcclusionConfig",
    "PlanningConfig",
    "PredictionConfig",
    "SimulationConfig",
    "VisualizationConfig",
    "load_config",
    "merge_overrides",
    "parse_cli_overrides",
    "simple_yaml_load",
]

DEFAULT_COST_WEIGHTS = {
    "acceleration": 0.0,
    "jerk": 0.0,
    "lateral_jerk": 0.2,
    "longitudinal_jerk": 0.2,
    "orientation_offset": 0.0,
    "path_length": 0.0,
    "lane_center_offset": 0.0,
    "velocity_offset": 1.0,
    "velocity": 0.0,
    "distance_to_reference_path": 5.0,
    "distance_to_obstacles": 0.0,
    "prediction": 0.2,
    "responsibility": 0.0,
}


@dataclass
class PlanningConfig:
    dt: float = 0.1
    planning_horizon: float = 3.0
    low_vel_mode_threshold: float = 2.0
    replanning_frequency: int = 3
    emergency_mode: str = "stopping"  # "stopping" | "min_risk"
    t_min: float = 1.1
    d_min: float = -3.0
    d_max: float = 3.0
    d_ego_pos: bool = False
    sampling_min: int = 2
    sampling_max: int = 3
    # fixed-order Neumaier cost summation (ops.costs.weighted_total)
    compensated_cost_sum: bool = False

    @property
    def n_steps(self) -> int:
        return int(self.planning_horizon / self.dt)


@dataclass
class DebugConfig:
    save_all_traj: bool = False          # every candidate of every cycle logged
    save_unweighted_costs: bool = False  # extra raw-term columns in logs.csv
    log_risk: bool = False               # the selected plan's ego/obstacle risk
    activate_logging: bool = True        # trajectory logs and simulation.db
    kinematic_debug: bool = True
    matrix_bucket: int = 256     # candidate-count padding bucket
    collision_report: bool = True        # a JSON report per collision


@dataclass
class SimulationConfig:
    max_steps_factor: float = 1.7
    fallback_max_steps: int = 200
    start_multiagent: bool = False
    used_planner_interface: str = "FrenetPlannerInterface"
    batched_device_agents: bool = False
    sharded_device_agents: bool = False
    device_resident_sim: bool = False
    check_road_boundary: bool = True     # executed off-road pose = failure
    # multi-agent selection: with use_specific_agents exactly `agent_ids`
    # become agents; otherwise `number_of_agents` of the dynamic obstacles
    # (-1: all), in scenario order or a random sample
    number_of_agents: int = -1
    use_specific_agents: bool = False
    agent_ids: list = field(default_factory=list)
    select_agents_randomly: bool = False
    # None → fresh entropy per run; an int pins the sample
    agent_selection_seed: Optional[int] = None
    msg_log_mode: str = "INFO"           # level of messages.log
    ego_agent_id: int = 60000


@dataclass
class PredictionConfig:
    mode: str = "ground_truth"  # "ground_truth" | "constant_velocity" | "walenet"
    horizon_steps: int = 30
    cov_pos: float = 0.5
    sensor_radius: float = 50.0
    use_sensor_model: bool = True   # radius + rear-cone filtering per agent
    calc_occlusions: bool = False
    cone_angle: float = 20.0
    cone_safety_dist: float = 6.0
    max_obstacles: int = 16     # padding bound of the prediction tensors
    uncertainty_margin_sigma: float = 0.0


@dataclass
class BehaviorConfig:
    """behavior.yaml, carried whole (off by default)."""

    use_behavior_planner: bool = False
    # behavior timing follows the planner (the agent copies planning.dt and
    # planning.replanning_frequency here)
    replanning_frequency: int = 3
    dt: float = 0.1
    stopping_mode_threshold: float = 10.0
    # the device-resident run: "auto" runs the FSM inside the run where
    # `behavior.device_fsm.build_fsm_tensors` supports the scenario, else the
    # hybrid path (host FSM between device cycles); "hybrid" forces the latter
    device_fsm: str = "auto"

    # path planner
    dist_between_points: float = 0.125
    stepwise_lane_changes: bool = True
    preparation_time: float = 3.0   # s, static Prepare* goal length
    goal_time: float = 2.0          # s, static goal length
    distance_self_intersection: float = 10.0

    # velocity planner
    ttc_norm: float = 8.0
    safety_distance_buffer: float = 2.0    # s
    a_max_delta: float = 0.3               # s
    comfortable_deceleration_rate: float = 3.4  # m/s²
    zero_velocity_threshold: float = 0.278      # m/s

    # stop point
    default_time_horizon: float = 2.0
    min_stop_point_dist: float = 1.4
    min_stop_point_time: float = 1.0
    standing_obstacle_vel: float = 1.0

    # lane-conflict clearance of turn and intersection situations
    intersection_time_gap: float = 2.0   # s, safety gap after the ego clears
    clearance_accel: float = 1.5         # m/s², assumed ego accel from the line

    # TTC conditioning of the velocity planner
    time_headway: float = 1.8
    ttc_threshold: float = 4.0


@dataclass
class OcclusionConfig:
    """Occlusion module (off by default).

    `metric_thresholds` activates the full metric gate (keys: harm, risk, cp,
    ttc, wttc, ttce, dce, be; None = deactivated).  `harm_threshold` and
    `risk_threshold` are the default gate's shorthand."""

    use_occlusion_module: bool = False
    harm_threshold: float = 0.1
    risk_threshold: float = 1.0
    metric_thresholds: dict = field(default_factory=dict)
    max_phantoms: int = 4
    phantom_type: str = "pedestrian"   # pedestrian | bicycle | car | truck
    # where phantoms spawn
    spawn_point_behind_dynamic_obstacle: bool = True
    spawn_point_behind_static_obstacle: bool = True
    spawn_points_behind_turn: bool = False
    max_dynamic_spawn_points: int = 4
    max_static_spawn_points: int = 4
    # inflation of the phantoms' predictions
    variance_factor: float = 1.05
    size_factor_length: float = 1.2
    size_factor_width: float = 1.3


@dataclass
class EvaluationConfig:
    """evaluation.yaml."""

    evaluate_agents: bool = False      # per-agent vehicle-dynamics solution check
    evaluate_simulation: bool = False  # criticality metrics for every agent
    evaluate_runtime: bool = False     # per-component timing tables
    radius: float = 100.0              # participants within this range count
    tau: float = 2.0                   # TET / TIT threshold
    a_max_lat: float = 8.0             # max lateral deceleration (a_lat_req)
    # per-metric enable map; metrics missing from the map stay enabled
    criticality_metrics: dict = field(default_factory=dict)


@dataclass
class VisualizationConfig:
    """visualization.yaml: per-step frames, the GIF and the final plots
    (`utils.visualization`; drawn by `Simulation.run` and `run_scenario.
    run_one`)."""

    save_plots: bool = False
    show_plots: bool = False    # live interactive rendering per plotted step
    plot_interval: int = 5      # plot every k-th step
    save_gif: bool = False
    draw_traj_set: bool = False  # draw the full candidate fan
    window: float = 60.0         # plot_window_dyn
    show_labels: bool = True             # vehicle-id annotations
    draw_icons: bool = False             # windshield icon on vehicle boxes
    draw_reference_path: bool = True
    draw_predictions: bool = True
    draw_planning_problem: bool = True   # goal regions as filled polygons


EXTERNAL_COST_KEYS = ("occ_pm", "occ_um", "occ_ve")


@dataclass
class FrenetixConfig:
    planning: PlanningConfig = field(default_factory=PlanningConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)
    simulation: SimulationConfig = field(default_factory=SimulationConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    behavior: BehaviorConfig = field(default_factory=BehaviorConfig)
    occlusion: OcclusionConfig = field(default_factory=OcclusionConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    vehicle: VehicleParams = field(default_factory=VehicleParams)
    cost_weights: dict = field(default_factory=lambda: dict(DEFAULT_COST_WEIGHTS))
    # soft occlusion cost terms (occlusion.external_occlusion_costs); they
    # need occlusion.use_occlusion_module
    external_cost_weights: dict = field(
        default_factory=lambda: dict.fromkeys(EXTERNAL_COST_KEYS, 0.0))
    dtype: str = "float32"      # "float32" on the card, "float64" for CPU parity


def _dict_key_schema(path: str):
    """The known keys of a fixed-schema dict field (a misspelled key there
    must not be a silent no-op), else None."""
    if path == "cost_weights":
        return set(DEFAULT_COST_WEIGHTS)
    if path == "external_cost_weights":
        return set(EXTERNAL_COST_KEYS)
    if path == "occlusion.metric_thresholds":
        # imported here: the occlusion package imports this module
        from frenetix_tpu_torch.occlusion import PhantomThresholds

        return set(PhantomThresholds._fields)
    if path == "evaluation.criticality_metrics":
        from frenetix_tpu_torch.evaluation.metrics import CRITICALITY_METRICS

        return set(CRITICALITY_METRICS)
    return None


def _apply_overrides(obj, overrides: dict, path: str, unknown: list) -> None:
    """Merge an override dict into the config tree; unknown keys are
    collected into `unknown`."""
    for k, v in overrides.items():
        if not hasattr(obj, k):
            unknown.append(f"{path}{k}")
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_overrides(cur, v, f"{path}{k}.", unknown)
        elif isinstance(cur, VehicleParams) and isinstance(v, dict):
            bad = [kk for kk in v if kk not in cur._fields
                   and kk not in ("cr_vehicle_id", "wb_front_axle")]
            unknown.extend(f"{path}{k}.{kk}" for kk in bad)
            if v.get("cr_vehicle_id") is not None:
                # every parameter from the vehicle-model database by id, then
                # the explicitly given non-None fields win
                ov = {kk: vv for kk, vv in v.items()
                      if kk != "cr_vehicle_id" and kk not in bad}
                setattr(obj, k, resolve_vehicle(v["cr_vehicle_id"], ov))
            else:
                setattr(obj, k, cur._replace(
                    **{kk: vv for kk, vv in v.items()
                       if kk in cur._fields and vv is not None}))
        elif isinstance(cur, dict) and isinstance(v, dict):
            allowed = _dict_key_schema(f"{path}{k}")
            if allowed is not None:
                unknown.extend(f"{path}{k}.{kk}" for kk in v if kk not in allowed)
            cur.update(v)
        else:
            setattr(obj, k, v)


# PyYAML's implicit resolvers (YAML 1.1, `yaml.resolver.Resolver`), each a
# full match of a plain scalar
_YAML_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF")
_YAML_NULL = re.compile(r"~|null|Null|NULL|")
_YAML_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# forms PyYAML resolves that this reader does not build: sexagesimal ints and
# floats, timestamps, the merge key and the value key
_YAML_REFUSED = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                           r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=")


def _yaml_int(s: str) -> int:
    """`SafeConstructor.construct_yaml_int` of a matched plain scalar."""
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    if s[0] in "+-":
        s = s[1:]
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    return sign * int(s)


def _yaml_float(s: str) -> float:
    """`SafeConstructor.construct_yaml_float` of a matched plain scalar."""
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    if s[0] in "+-":
        s = s[1:]
    if s == ".inf":
        return sign * float("inf")
    if s == ".nan":
        return float("nan")
    return sign * float(s)


def _yaml_quoted(s: str) -> str:
    """A quoted scalar on one line: '' escapes a single quote; a double-quoted
    scalar with a backslash escape is not read here."""
    body = s[1:-1]
    if s[0] == "'":
        if "'" in body.replace("''", ""):
            raise ValueError(f"unsupported YAML scalar {s!r}")
        return body.replace("''", "'")
    if "\\" in body or '"' in body:
        raise ValueError(f"unsupported YAML scalar {s!r} (escapes)")
    return body


def _split_flow(body: str) -> list:
    """The items of a one-line flow list, split at commas outside quotes."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ",":
            items.append(cur)
            cur = ""
            continue
        cur += ch
    return items + [cur]


def _yaml_scalar(text: str):
    """One scalar as `yaml.safe_load` resolves it: a quoted string, a flow
    list of scalars, or a plain scalar through PyYAML's resolvers (null,
    bool, int, float, else a string).  A form this reader does not build
    raises ValueError, so it never returns a string where PyYAML would
    return something else."""
    s = text.strip()
    if s[:1] == "[":
        body = s[1:-1].strip() if s.endswith("]") else None
        if body is None or any(c in body for c in "[]{}"):
            raise ValueError(f"unsupported YAML flow collection {s!r}")
        if not body:
            return []
        items = _split_flow(body)
        if items[-1].strip() == "":        # a trailing comma
            items.pop()
        if any(not x.strip() for x in items):
            raise ValueError(f"unsupported YAML flow list {s!r}")
        return [_yaml_scalar(x) for x in items]
    if s[:1] in ("'", '"'):
        if len(s) < 2 or s[-1] != s[0]:
            raise ValueError(f"unsupported YAML scalar {s!r}")
        return _yaml_quoted(s)
    if (s[:1] in tuple("{]}&*!|>%@`,?:#") or s[:2] == "- " or s == "-"
            or ": " in s or " #" in s or s.endswith(":")):
        raise ValueError(f"unsupported YAML scalar {s!r}")
    if _YAML_NULL.fullmatch(s):
        return None
    if _YAML_BOOL.fullmatch(s):
        return s.lower() in ("yes", "true", "on")
    if _YAML_INT.fullmatch(s):
        return _yaml_int(s)
    if _YAML_FLOAT.fullmatch(s):
        return _yaml_float(s)
    if _YAML_REFUSED.fullmatch(s):
        raise ValueError(f"unsupported YAML scalar {s!r} (PyYAML reads it as "
                         "a sexagesimal number, a timestamp or a special key)")
    return s


def _strip_comment(line: str) -> str:
    """`line` without its comment: a # at the start or after white space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _key_split(line: str):
    """(key, value) at the first ': ' (or a final ':') outside quotes, or
    None."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(line) or line[i + 1] == " "):
            return line[:i], line[i + 1:]
    return None


def simple_yaml_load(text: str) -> dict:
    """The YAML subset of the configuration files, for machines without
    PyYAML: nested block mappings by indentation, `key: scalar` lines, flow
    lists of scalars and comments.  Scalars resolve as `yaml.safe_load`
    resolves them (`_yaml_scalar`); a key with nothing after it and no
    deeper lines is null.  Anything else raises ValueError."""
    root: dict = {}
    stack = [(-1, root, None, None)]     # (indent, mapping, parent, key)

    def pop():
        _, mapping, parent, key = stack.pop()
        if parent is not None and not mapping:
            parent[key] = None           # `key:` with no deeper lines

    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise ValueError(f"unsupported YAML at line {lineno} (a tab): {raw!r}")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() == "---" and not root:
            continue                     # the start of the one document
        indent = len(line) - len(line.lstrip(" "))
        parts = _key_split(line.strip())
        if parts is None:
            raise ValueError(f"unsupported YAML at line {lineno}: {raw!r}")
        key = _yaml_scalar(parts[0]) if parts[0] else None
        if not isinstance(key, str):
            raise ValueError(f"unsupported YAML key at line {lineno}: {raw!r}")
        while indent <= stack[-1][0]:
            pop()
        parent = stack[-1][1]
        value = parts[1].strip()
        if value:
            parent[key] = _yaml_scalar(value)
        else:
            parent[key] = {}
            stack.append((indent, parent[key], parent, key))
    while len(stack) > 1:
        pop()
    return root


def parse_cli_overrides(items) -> dict:
    """`["a.b=1", "cost_weights.prediction=0.5"]` → nested override dict.

    Each value resolves as a YAML scalar, as `yaml.safe_load` resolves it
    (null, bool, int, float, a flow list of scalars, else a string), through
    `_yaml_scalar`, which needs no PyYAML and raises ValueError for a form
    it does not build."""
    out: dict = {}
    for item in items or []:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not KEY=VALUE")
        key, raw = item.split("=", 1)
        value = _yaml_scalar(raw)
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_config(config_dir: Optional[str] = None, overrides: Optional[dict] = None,
                strict_overrides: bool = False) -> FrenetixConfig:
    """Defaults ← `<config_dir>/*.yaml` (each file merges under its stem;
    cost.yaml's `cost_weights` and `external_cost_weights` at the root) ←
    `overrides`.  YAML keys the port does not know are ignored; with
    `strict_overrides` an unknown key
    in `overrides` raises.  PyYAML is imported only when a directory is
    given; without it `simple_yaml_load` reads the files."""
    cfg = FrenetixConfig()
    if config_dir and os.path.isdir(config_dir):
        try:
            import yaml

            safe_load = yaml.safe_load
        except ImportError:        # a machine without PyYAML
            safe_load = simple_yaml_load
        merged: dict = {}
        for fname in sorted(os.listdir(config_dir)):
            if not fname.endswith((".yaml", ".yml")):
                continue
            with open(os.path.join(config_dir, fname)) as f:
                data = safe_load(f.read()) or {}
            stem = os.path.splitext(fname)[0]
            if stem == "cost":
                # cost.yaml's two maps are root-level config fields
                for key in ("cost_weights", "external_cost_weights"):
                    if key in data:
                        merged.setdefault(key, {}).update(data[key])
            else:
                merged.setdefault(stem, {}).update(data)
        _apply_overrides(cfg, merged, "", [])
    if overrides:
        merge_overrides(cfg, overrides, strict=strict_overrides)
    return cfg


def merge_overrides(cfg: FrenetixConfig, overrides: dict, strict: bool = True) -> None:
    """Merge a nested override dict (`parse_cli_overrides`) into `cfg`; with
    `strict` an unknown key raises ValueError (a misspelled `--set` key must
    not be a silent no-op)."""
    unknown: list = []
    _apply_overrides(cfg, overrides, "", unknown)
    if strict and unknown:
        raise ValueError(f"unknown config override key(s): {unknown}")
