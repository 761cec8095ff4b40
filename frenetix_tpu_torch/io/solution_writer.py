"""CommonRoad competition solution XML writer/reader (2020a format).

The port's own copy of `frenetix_tpu/io/solution_writer.py` (standard
library only).  It writes what commonroad-io's `CommonRoadSolutionWriter`
writes for a PlanningProblemSolution with VehicleModel.KS,
VehicleType(cr_vehicle_id) and CostFunction.WX1, without that dependency:

  * `solution_to_xml` / `write_solution` — one `<CommonRoadSolution>` with
    a `ksTrajectory` per planning problem; benchmark id
    `{model}{type}:{cost}:{scenario_id}:2020a` (the published benchmark-id
    scheme, e.g. "KS2:WX1:ZAM_Tjunction-1_23_T-1:2020a").
  * `read_solution` — parses the same format back into plain state rows,
    so written solutions can be re-checked by
    `evaluation.solution_check.check_solution` (KS forward simulation).

Positions follow the CommonRoad CENTER convention: the executed EgoStates
are already center-frame, so states serialize unshifted.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from types import SimpleNamespace

__all__ = ["solution_to_xml", "write_solution", "read_solution",
           "benchmark_id"]


def benchmark_id(scenario_id: str, *, vehicle_model: str = "KS",
                 cr_vehicle_id: int = 2, cost_function: str = "WX1") -> str:
    return f"{vehicle_model}{int(cr_vehicle_id)}:{cost_function}:" \
           f"{scenario_id}:2020a"


def _exact(parent, tag, value, fmt="{:.17g}"):
    e = ET.SubElement(parent, tag)
    ET.SubElement(e, "exact").text = fmt.format(value)


def solution_to_xml(scenario_id: str, trajectories: dict, dt: float, *,
                    vehicle_model: str = "KS", cr_vehicle_id: int = 2,
                    cost_function: str = "WX1",
                    computation_time: float | None = None,
                    date: str | None = None,
                    cost_weights: dict | None = None) -> ET.Element:
    """`trajectories`: {planning_problem_id: [states]} — each state needs
    position (center), orientation, velocity, steering_angle, time_step.
    `date` defaults to today (ISO).  `cost_weights`: the weight set used
    when the cost was computed locally — stamped as an attribute so a
    consumer can tell which (possibly estimated) weights produced any
    logged cost (evaluation/solution_cost.py COST_COMBINATIONS are
    estimated transcriptions, not the official catalog)."""
    if date is None:
        import datetime

        date = datetime.date.today().isoformat()
    attrs = {
        "benchmark_id": benchmark_id(
            scenario_id, vehicle_model=vehicle_model,
            cr_vehicle_id=cr_vehicle_id, cost_function=cost_function),
        "date": date,
    }
    if cost_weights is not None:
        attrs["cost_weights"] = ";".join(
            f"{k}={v:g}" for k, v in sorted(cost_weights.items()))
    if computation_time is not None:
        attrs["computation_time"] = f"{computation_time:.6f}"
    root = ET.Element("CommonRoadSolution", attrs)
    tag = f"{vehicle_model.lower()}Trajectory"
    state_tag = f"{vehicle_model.lower()}State"
    for pp_id, states in trajectories.items():
        el = ET.SubElement(root, tag, {"planningProblem": str(pp_id)})
        for st in states:
            se = ET.SubElement(el, state_tag)
            _exact(se, "time", int(st.time_step), fmt="{:d}")
            pos = ET.SubElement(se, "position")
            pt = ET.SubElement(pos, "point")
            ET.SubElement(pt, "x").text = f"{float(st.position[0]):.17g}"
            ET.SubElement(pt, "y").text = f"{float(st.position[1]):.17g}"
            _exact(se, "orientation", float(st.orientation))
            if vehicle_model == "KS":
                _exact(se, "steeringAngle",
                       float(getattr(st, "steering_angle", 0.0)))
            _exact(se, "velocity", float(st.velocity))
    return root


def write_solution(path: str, scenario_id: str, trajectories: dict,
                   dt: float, **kw) -> str:
    root = solution_to_xml(scenario_id, trajectories, dt, **kw)
    ET.indent(ET.ElementTree(root))
    ET.ElementTree(root).write(path, encoding="UTF-8", xml_declaration=True)
    return path


def read_solution(path: str, dt: float | None = None):
    """Parse a solution XML back: (benchmark_id, {pp_id: [states]}).
    States are SimpleNamespaces with position/orientation/velocity/
    steering_angle/time_step — directly consumable by
    evaluation.solution_check.check_solution.  The format does not carry
    acceleration (CommonRoad reconstructs it by forward simulation);
    with `dt` given it is rebuilt as a central difference over the
    (previous, next) states (one-sided at the ends)."""
    root = ET.parse(path).getroot()
    out = {}
    for traj in root:
        if not traj.tag.endswith("Trajectory"):
            continue
        pp_id = int(traj.get("planningProblem"))
        states = []
        for se in traj:
            def ex(tag, default=None):
                el = se.find(f"{tag}/exact")
                if el is None:
                    return default
                return float(el.text)
            pt = se.find("position/point")
            states.append(SimpleNamespace(
                time_step=int(ex("time")),
                position=(float(pt.find("x").text), float(pt.find("y").text)),
                orientation=ex("orientation"),
                velocity=ex("velocity"),
                steering_angle=ex("steeringAngle", 0.0),
            ))
        states.sort(key=lambda s: s.time_step)
        if dt:
            for k, s in enumerate(states):
                nxt = states[min(k + 1, len(states) - 1)]
                prv = states[max(k - 1, 0)]
                s.acceleration = (nxt.velocity - prv.velocity) / (
                    (nxt.time_step - prv.time_step) * dt or 1.0)
        out[pp_id] = states
    return root.get("benchmark_id"), out
