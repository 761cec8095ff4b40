"""CommonRoad 2020a scenario XML writer.

The port's own copy of `frenetix_tpu/io/commonroad_writer.py` (standard
library and NumPy), the counterpart of the reader (io/commonroad.py): it
serializes a `Scenario` back to the 2020a XML format with the round-trip
fidelity the planning stack needs (lanelets with bounds and topology,
traffic signs and lights, intersections, obstacles with trajectories,
planning problems with goal regions).  Its output is byte for byte the JAX
package's.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

__all__ = ["write_scenario", "scenario_to_xml"]


def _pt(parent, x, y):
    p = ET.SubElement(parent, "point")
    ET.SubElement(p, "x").text = f"{x:.4f}"
    ET.SubElement(p, "y").text = f"{y:.4f}"


def _exact(parent, tag, value):
    e = ET.SubElement(parent, tag)
    ET.SubElement(e, "exact").text = f"{value}"


def _state(parent, tag, st):
    el = ET.SubElement(parent, tag)
    pos = ET.SubElement(el, "position")
    _pt(pos, st.position[0], st.position[1])
    _exact(el, "orientation", round(float(st.orientation), 7))
    _exact(el, "time", int(st.time_step))
    _exact(el, "velocity", round(float(st.velocity), 7))
    _exact(el, "acceleration", round(float(st.acceleration), 7))
    return el


def scenario_to_xml(scenario) -> ET.Element:
    root = ET.Element(
        "commonRoad",
        {
            "timeStepSize": str(scenario.dt),
            "commonRoadVersion": "2020a",
            "author": "frenetix_tpu",
            "affiliation": "frenetix_tpu",
            "source": "frenetix_tpu scenario writer",
            "benchmarkID": scenario.scenario_id,
            "date": "2026-01-01",
        },
    )

    for ll in scenario.lanelets.values():
        el = ET.SubElement(root, "lanelet", {"id": str(ll.lanelet_id)})
        left = ET.SubElement(el, "leftBound")
        for x, y in ll.left_vertices:
            _pt(left, x, y)
        if ll.line_marking_left:
            ET.SubElement(left, "lineMarking").text = ll.line_marking_left
        right = ET.SubElement(el, "rightBound")
        for x, y in ll.right_vertices:
            _pt(right, x, y)
        if ll.line_marking_right:
            ET.SubElement(right, "lineMarking").text = ll.line_marking_right
        for s in ll.predecessors:
            ET.SubElement(el, "predecessor", {"ref": str(s)})
        for s in ll.successors:
            ET.SubElement(el, "successor", {"ref": str(s)})
        if ll.adj_left is not None:
            ET.SubElement(el, "adjacentLeft", {
                "ref": str(ll.adj_left),
                "drivingDir": "same" if ll.adj_left_same_direction else "opposite",
            })
        if ll.adj_right is not None:
            ET.SubElement(el, "adjacentRight", {
                "ref": str(ll.adj_right),
                "drivingDir": "same" if ll.adj_right_same_direction else "opposite",
            })
        if ll.stop_line is not None:
            sl = ET.SubElement(el, "stopLine")
            _pt(sl, *ll.stop_line.start)
            _pt(sl, *ll.stop_line.end)
            ET.SubElement(sl, "lineMarking").text = ll.stop_line.line_marking
            for r in ll.stop_line.traffic_sign_refs:
                ET.SubElement(sl, "trafficSignRef", {"ref": str(r)})
            for r in ll.stop_line.traffic_light_refs:
                ET.SubElement(sl, "trafficLightRef", {"ref": str(r)})
        ET.SubElement(el, "laneletType").text = ll.lanelet_type or "urban"
        for r in ll.traffic_sign_refs:
            ET.SubElement(el, "trafficSignRef", {"ref": str(r)})
        for r in ll.traffic_light_refs:
            ET.SubElement(el, "trafficLightRef", {"ref": str(r)})

    for ts in getattr(scenario, "traffic_signs", {}).values():
        el = ET.SubElement(root, "trafficSign", {"id": str(ts.sign_id)})
        for sid, vals in ts.elements:
            se = ET.SubElement(el, "trafficSignElement")
            ET.SubElement(se, "trafficSignID").text = sid
            for v in vals:
                ET.SubElement(se, "additionalValue").text = str(v)
        if ts.position is not None:
            pos = ET.SubElement(el, "position")
            _pt(pos, *ts.position)
        ET.SubElement(el, "virtual").text = "true" if ts.virtual else "false"

    for tl in getattr(scenario, "traffic_lights", {}).values():
        el = ET.SubElement(root, "trafficLight", {"id": str(tl.light_id)})
        cyc = ET.SubElement(el, "cycle")
        for color, dur in tl.cycle:
            ce = ET.SubElement(cyc, "cycleElement")
            ET.SubElement(ce, "duration").text = str(dur)
            ET.SubElement(ce, "color").text = color
        if tl.time_offset:
            ET.SubElement(cyc, "timeOffset").text = str(tl.time_offset)
        if tl.position is not None:
            pos = ET.SubElement(el, "position")
            _pt(pos, *tl.position)
        ET.SubElement(el, "active").text = "true" if tl.active else "false"

    for inter in getattr(scenario, "intersections", []):
        el = ET.SubElement(root, "intersection", {"id": str(inter.intersection_id)})
        for inc in inter.incomings:
            ie = ET.SubElement(el, "incoming", {"id": str(inc.incoming_id)})
            for r in inc.incoming_lanelets:
                ET.SubElement(ie, "incomingLanelet", {"ref": str(r)})
            for tag, refs in (("successorsLeft", inc.successors_left),
                              ("successorsRight", inc.successors_right),
                              ("successorsStraight", inc.successors_straight)):
                for r in refs:
                    ET.SubElement(ie, tag, {"ref": str(r)})

    for ob in scenario.obstacles.values():
        tag = "dynamicObstacle" if ob.role == "dynamic" else "staticObstacle"
        el = ET.SubElement(root, tag, {"id": str(ob.obstacle_id)})
        ET.SubElement(el, "type").text = ob.obstacle_type
        shape = ET.SubElement(el, "shape")
        rect = ET.SubElement(shape, "rectangle")
        ET.SubElement(rect, "length").text = f"{ob.length}"
        ET.SubElement(rect, "width").text = f"{ob.width}"
        _state(el, "initialState", ob.initial_state)
        if ob.role == "dynamic" and ob.trajectory:
            traj = ET.SubElement(el, "trajectory")
            for st in ob.trajectory:
                _state(traj, "state", st)

    for pp in scenario.planning_problems.values():
        el = ET.SubElement(root, "planningProblem", {"id": str(pp.problem_id)})
        init = _state(el, "initialState", pp.initial_state)
        _exact(init, "yawRate", 0.0)
        _exact(init, "slipAngle", 0.0)
        for g in pp.goals:
            gs = ET.SubElement(el, "goalState")
            if g.position_lanelets or g.position_shape is not None:
                pos = ET.SubElement(gs, "position")
                for lid in g.position_lanelets:
                    ET.SubElement(pos, "lanelet", {"ref": str(lid)})
                if g.position_shape is not None:
                    c = np.mean(g.position_shape, axis=0)
                    ext = g.position_shape.max(axis=0) - g.position_shape.min(axis=0)
                    rect = ET.SubElement(pos, "rectangle")
                    ET.SubElement(rect, "length").text = f"{ext[0]:.3f}"
                    ET.SubElement(rect, "width").text = f"{ext[1]:.3f}"
                    ET.SubElement(rect, "orientation").text = "0.0"
                    center = ET.SubElement(rect, "center")
                    ET.SubElement(center, "x").text = f"{c[0]:.3f}"
                    ET.SubElement(center, "y").text = f"{c[1]:.3f}"
            if g.time_interval is not None:
                t = ET.SubElement(gs, "time")
                ET.SubElement(t, "intervalStart").text = str(g.time_interval[0])
                ET.SubElement(t, "intervalEnd").text = str(g.time_interval[1])
            if g.velocity_interval is not None:
                v = ET.SubElement(gs, "velocity")
                ET.SubElement(v, "intervalStart").text = str(g.velocity_interval[0])
                ET.SubElement(v, "intervalEnd").text = str(g.velocity_interval[1])
    return root


def write_scenario(scenario, path: str):
    root = scenario_to_xml(scenario)
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="UTF-8", xml_declaration=True)
    return path
