"""CommonRoad 2020a scenario XML reader (host-side, stdlib ElementTree).

The port's own copy of `frenetix_tpu/io/commonroad.py`: a dependency-free
reader covering what the planning stack consumes: the lanelet network
(bounds, topology, adjacency), static and dynamic obstacles with their
trajectories, and planning problems (initial state + goal region with
position/time/velocity/orientation conditions).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = [
    "Lanelet",
    "Obstacle",
    "State",
    "GoalCondition",
    "PlanningProblem",
    "StopLine",
    "TrafficSign",
    "TrafficLight",
    "Intersection",
    "IntersectionIncoming",
    "Scenario",
    "load_scenario",
    "speed_limit_for_lanelets",
]


@dataclass
class State:
    """One trajectory/initial state (exact values)."""

    time_step: int
    position: np.ndarray  # (2,)
    orientation: float = 0.0
    velocity: float = 0.0
    acceleration: float = 0.0
    yaw_rate: float = 0.0


@dataclass
class StopLine:
    """Lanelet stop line (CommonRoad `<stopLine>`): geometry + the traffic
    signs/lights it belongs to (used by the behavior planner's static route
    scan, reference behavior_planner/utils/path_planner.py:499-584)."""

    start: np.ndarray  # (2,)
    end: np.ndarray    # (2,)
    line_marking: str = "solid"
    traffic_sign_refs: list[int] = field(default_factory=list)
    traffic_light_refs: list[int] = field(default_factory=list)

    @property
    def center(self) -> np.ndarray:
        return (self.start + self.end) / 2.0


@dataclass
class TrafficSign:
    """CommonRoad `<trafficSign>`: elements are (sign_id, additional_values)
    pairs; positions/values are SI (speed limits in m/s)."""

    sign_id: int
    elements: list[tuple[str, list[float]]]
    position: Optional[np.ndarray] = None  # (2,)
    virtual: bool = False

    def max_speed(self) -> Optional[float]:
        """Speed limit in m/s if this is a max-speed sign (DEU/ZAM id 274,
        USA R2-1), else None."""
        for sid, vals in self.elements:
            if sid in ("274", "R2-1", "r2-1") and vals:
                return float(vals[0])
        return None

    def has(self, *names: str) -> bool:
        """True if any element id matches one of the given ids."""
        return any(sid in names for sid, _ in self.elements)

    @property
    def is_stop(self) -> bool:
        return self.has("206", "R1-1")   # DEU 206 / USA R1-1 = STOP

    @property
    def is_yield(self) -> bool:
        return self.has("205", "R1-2")   # DEU 205 / USA R1-2 = YIELD


@dataclass
class TrafficLight:
    """CommonRoad `<trafficLight>`: a fixed signal cycle of (color, duration)
    phases in scenario time steps, shifted by `time_offset`."""

    light_id: int
    cycle: list[tuple[str, int]] = field(default_factory=list)  # (color, #steps)
    position: Optional[np.ndarray] = None
    time_offset: int = 0
    active: bool = True

    @property
    def cycle_length(self) -> int:
        return sum(d for _, d in self.cycle)

    def state_at_time(self, time_step: int) -> str:
        """Color ('red'|'redYellow'|'yellow'|'green'|'inactive') at a step."""
        if not self.cycle or not self.active:
            return "inactive"
        t = (time_step - self.time_offset) % self.cycle_length
        for color, duration in self.cycle:
            if t < duration:
                return color
            t -= duration
        return self.cycle[-1][0]


@dataclass
class IntersectionIncoming:
    incoming_id: int
    incoming_lanelets: list[int] = field(default_factory=list)
    successors_left: list[int] = field(default_factory=list)
    successors_right: list[int] = field(default_factory=list)
    successors_straight: list[int] = field(default_factory=list)


@dataclass
class Intersection:
    intersection_id: int
    incomings: list[IntersectionIncoming] = field(default_factory=list)


@dataclass
class Lanelet:
    lanelet_id: int
    left_vertices: np.ndarray   # (V, 2)
    right_vertices: np.ndarray  # (V, 2)
    center_vertices: np.ndarray  # (V, 2)
    successors: list[int] = field(default_factory=list)
    predecessors: list[int] = field(default_factory=list)
    adj_left: Optional[int] = None
    adj_left_same_direction: bool = False
    adj_right: Optional[int] = None
    adj_right_same_direction: bool = False
    lanelet_type: str = ""
    stop_line: Optional[StopLine] = None
    traffic_sign_refs: list[int] = field(default_factory=list)
    traffic_light_refs: list[int] = field(default_factory=list)
    line_marking_left: str = ""    # '' (unknown) | dashed | solid | broad_* …
    line_marking_right: str = ""

    @property
    def polygon(self) -> np.ndarray:
        """Closed ring: left bound + reversed right bound (cached — hot in
        membership scans; vertices are never reassigned after construction)."""
        ring = getattr(self, "_polygon", None)
        if ring is None:
            ring = np.concatenate(
                [self.left_vertices, self.right_vertices[::-1]], axis=0)
            object.__setattr__(self, "_polygon", ring)
            object.__setattr__(self, "_bbox", (
                float(ring[:, 0].min()), float(ring[:, 0].max()),
                float(ring[:, 1].min()), float(ring[:, 1].max())))
        return ring

    def contains_point(self, p) -> bool:
        p = np.asarray(p, dtype=np.float64)
        ring = self.polygon
        x0, x1, y0, y1 = self._bbox
        if p[0] < x0 or p[0] > x1 or p[1] < y0 or p[1] > y1:
            return False
        return bool(_point_in_ring(p, ring))


@dataclass
class Obstacle:
    obstacle_id: int
    obstacle_type: str          # car / truck / pedestrian / ...
    role: str                   # "dynamic" | "static"
    length: float
    width: float
    initial_state: State
    trajectory: list[State] = field(default_factory=list)  # dynamic only
    shape_kind: str = "rectangle"

    def state_at_time(self, t: int) -> Optional[State]:
        """State at scenario time step t; None once the obstacle disappears
        (matches commonroad DynamicObstacle.state_at_time semantics)."""
        if t == self.initial_state.time_step:
            return self.initial_state
        if self.role == "static":
            s = self.initial_state
            return State(t, s.position, s.orientation, 0.0, 0.0)
        for st in self.trajectory:
            if st.time_step == t:
                return st
        return None

    @property
    def final_time_step(self) -> int:
        if self.trajectory:
            return self.trajectory[-1].time_step
        return self.initial_state.time_step


@dataclass
class GoalCondition:
    """One goal state of a planning problem (conditions AND-combined)."""

    position_lanelets: list[int] = field(default_factory=list)
    position_shape: Optional[np.ndarray] = None  # (V, 2) polygon ring
    time_interval: Optional[tuple[int, int]] = None
    velocity_interval: Optional[tuple[float, float]] = None
    orientation_interval: Optional[tuple[float, float]] = None


@dataclass
class PlanningProblem:
    problem_id: int
    initial_state: State
    goals: list[GoalCondition]


@dataclass
class Scenario:
    scenario_id: str
    dt: float
    lanelets: dict[int, Lanelet]
    obstacles: dict[int, Obstacle]
    planning_problems: dict[int, PlanningProblem]
    traffic_signs: dict[int, TrafficSign] = field(default_factory=dict)
    traffic_lights: dict[int, TrafficLight] = field(default_factory=dict)
    intersections: list[Intersection] = field(default_factory=list)
    tags: list[str] = field(default_factory=list)

    @property
    def country(self) -> str:
        """Country code from the benchmark id (e.g. 'ZAM_Tjunction-…' → ZAM)."""
        return self.scenario_id[:3] if len(self.scenario_id) >= 3 else ""

    @property
    def dynamic_obstacles(self) -> list[Obstacle]:
        return [o for o in self.obstacles.values() if o.role == "dynamic"]

    @property
    def static_obstacles(self) -> list[Obstacle]:
        return [o for o in self.obstacles.values() if o.role == "static"]

    @property
    def max_time_step(self) -> int:
        steps = [o.final_time_step for o in self.dynamic_obstacles]
        return max(steps) if steps else 0

    def find_lanelets_by_position(self, p) -> list[int]:
        p = np.asarray(p, dtype=np.float64)
        return [lid for lid, ll in self.lanelets.items() if ll.contains_point(p)]

    def drivable_polygons(self) -> list[np.ndarray]:
        return [ll.polygon for ll in self.lanelets.values()]


# --------------------------------------------------------------------------
# parsing helpers
# --------------------------------------------------------------------------


def _point_in_ring(p: np.ndarray, ring: np.ndarray) -> bool:
    a = ring
    b = np.roll(ring, -1, axis=0)
    cond = (a[:, 1] > p[1]) != (b[:, 1] > p[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = a[:, 0] + (p[1] - a[:, 1]) * (b[:, 0] - a[:, 0]) / (b[:, 1] - a[:, 1])
    return bool(np.sum(cond & (p[0] < x_int)) % 2)


def _points(el) -> np.ndarray:
    pts = [
        (float(pt.findtext("x")), float(pt.findtext("y"))) for pt in el.findall("point")
    ]
    return np.asarray(pts, dtype=np.float64)


def _exact(el, name, default=0.0) -> float:
    sub = el.find(name)
    if sub is None:
        return default
    txt = sub.findtext("exact")
    return float(txt) if txt is not None else default


def _interval(el, name):
    sub = el.find(name)
    if sub is None:
        return None
    lo = sub.findtext("intervalStart")
    hi = sub.findtext("intervalEnd")
    if lo is None or hi is None:
        ex = sub.findtext("exact")
        if ex is not None:
            return (float(ex), float(ex))
        return None
    return (float(lo), float(hi))


def _parse_state(el) -> State:
    pos_el = el.find("position")
    point = pos_el.find("point") if pos_el is not None else None
    if point is not None:
        position = np.array(
            [float(point.findtext("x")), float(point.findtext("y"))], dtype=np.float64
        )
    else:
        position = np.zeros(2)
    t = el.find("time")
    time_step = int(float(t.findtext("exact"))) if t is not None and t.findtext("exact") else 0
    return State(
        time_step=time_step,
        position=position,
        orientation=_exact(el, "orientation"),
        velocity=_exact(el, "velocity"),
        acceleration=_exact(el, "acceleration"),
        yaw_rate=_exact(el, "yawRate"),
    )


def _parse_lanelet(el) -> Lanelet:
    left_el, right_el = el.find("leftBound"), el.find("rightBound")
    left = _points(left_el)
    right = _points(right_el)
    n = min(len(left), len(right))
    left, right = left[:n], right[:n]
    ll = Lanelet(
        lanelet_id=int(el.attrib["id"]),
        left_vertices=left,
        right_vertices=right,
        center_vertices=(left + right) / 2.0,
        successors=[int(s.attrib["ref"]) for s in el.findall("successor")],
        predecessors=[int(s.attrib["ref"]) for s in el.findall("predecessor")],
        lanelet_type=(el.findtext("laneletType") or "").strip(),
        traffic_sign_refs=[int(s.attrib["ref"]) for s in el.findall("trafficSignRef")],
        traffic_light_refs=[int(s.attrib["ref"]) for s in el.findall("trafficLightRef")],
        line_marking_left=(left_el.findtext("lineMarking") or "").strip(),
        line_marking_right=(right_el.findtext("lineMarking") or "").strip(),
    )
    adj_l = el.find("adjacentLeft")
    if adj_l is not None:
        ll.adj_left = int(adj_l.attrib["ref"])
        ll.adj_left_same_direction = adj_l.attrib.get("drivingDir", "same") == "same"
    adj_r = el.find("adjacentRight")
    if adj_r is not None:
        ll.adj_right = int(adj_r.attrib["ref"])
        ll.adj_right_same_direction = adj_r.attrib.get("drivingDir", "same") == "same"
    sl_el = el.find("stopLine")
    if sl_el is not None:
        pts = sl_el.findall("point")
        if len(pts) >= 2:
            p0 = np.array([float(pts[0].findtext("x")), float(pts[0].findtext("y"))])
            p1 = np.array([float(pts[1].findtext("x")), float(pts[1].findtext("y"))])
        elif len(pts) == 1:
            p0 = p1 = np.array([float(pts[0].findtext("x")), float(pts[0].findtext("y"))])
        else:  # stop line spanning the lanelet end (no explicit points)
            p0, p1 = left[-1], right[-1]
        ll.stop_line = StopLine(
            start=p0, end=p1,
            line_marking=(sl_el.findtext("lineMarking") or "solid").strip(),
            traffic_sign_refs=[int(s.attrib["ref"]) for s in sl_el.findall("trafficSignRef")],
            traffic_light_refs=[int(s.attrib["ref"]) for s in sl_el.findall("trafficLightRef")],
        )
    return ll


def _parse_traffic_sign(el) -> TrafficSign:
    elements = []
    for se in el.findall("trafficSignElement"):
        sid = (se.findtext("trafficSignID") or "").strip()
        vals = [float(v.text) for v in se.findall("additionalValue") if v.text]
        elements.append((sid, vals))
    pos_el = el.find("position")
    pos = None
    if pos_el is not None:
        pt = pos_el.find("point")
        if pt is not None:
            pos = np.array([float(pt.findtext("x")), float(pt.findtext("y"))])
    return TrafficSign(
        sign_id=int(el.attrib["id"]),
        elements=elements,
        position=pos,
        virtual=(el.findtext("virtual") or "false").strip() == "true",
    )


def _parse_traffic_light(el) -> TrafficLight:
    cycle = []
    cycle_el = el.find("cycle")
    if cycle_el is not None:
        for ce in cycle_el.findall("cycleElement"):
            color = (ce.findtext("color") or "red").strip()
            duration = int(float(ce.findtext("duration") or "1"))
            cycle.append((color, duration))
        offset = int(float(cycle_el.findtext("timeOffset") or "0"))
    else:
        offset = 0
    pos_el = el.find("position")
    pos = None
    if pos_el is not None:
        pt = pos_el.find("point")
        if pt is not None:
            pos = np.array([float(pt.findtext("x")), float(pt.findtext("y"))])
    return TrafficLight(
        light_id=int(el.attrib["id"]),
        cycle=cycle,
        position=pos,
        time_offset=offset,
        active=(el.findtext("active") or "true").strip() != "false",
    )


def _parse_intersection(el) -> Intersection:
    incomings = []
    for inc in el.findall("incoming"):
        incomings.append(IntersectionIncoming(
            incoming_id=int(inc.attrib.get("id", "0")),
            incoming_lanelets=[int(r.attrib["ref"]) for r in inc.findall("incomingLanelet")],
            successors_left=[int(r.attrib["ref"]) for r in inc.findall("successorsLeft")],
            successors_right=[int(r.attrib["ref"]) for r in inc.findall("successorsRight")],
            successors_straight=[int(r.attrib["ref"]) for r in inc.findall("successorsStraight")],
        ))
    return Intersection(intersection_id=int(el.attrib.get("id", "0")), incomings=incomings)


# speed-limit sign ids by country family (values stored in m/s in the XML)
_MAX_SPEED_SIGN_IDS = ("274", "R2-1", "r2-1")


def speed_limit_for_lanelets(scenario: "Scenario", lanelet_ids) -> Optional[float]:
    """Minimum speed limit over max-speed signs attached to the given lanelets
    (the reference's TrafficSignInterpreter.speed_limit,
    behavior_planner/utils/helper_functions.py:196-198)."""
    limits = []
    for lid in lanelet_ids:
        ll = scenario.lanelets.get(lid)
        if ll is None:
            continue
        for sid in ll.traffic_sign_refs:
            sign = scenario.traffic_signs.get(sid)
            if sign is None:
                continue
            v = sign.max_speed()
            if v is not None:
                limits.append(v)
    return min(limits) if limits else None


def _parse_shape(el) -> tuple[str, float, float]:
    rect = el.find("rectangle")
    if rect is not None:
        return "rectangle", float(rect.findtext("length")), float(rect.findtext("width"))
    circ = el.find("circle")
    if circ is not None:
        r = float(circ.findtext("radius"))
        return "circle", 2 * r, 2 * r
    poly = el.find("polygon")
    if poly is not None:
        pts = _points(poly)
        ext = pts.max(axis=0) - pts.min(axis=0)
        return "polygon", float(ext[0]), float(ext[1])
    return "rectangle", 4.5, 2.0


def _parse_obstacle(el, role: str) -> Obstacle:
    kind, length, width = _parse_shape(el.find("shape"))
    init = _parse_state(el.find("initialState"))
    traj = []
    traj_el = el.find("trajectory")
    if traj_el is not None:
        traj = [_parse_state(st) for st in traj_el.findall("state")]
        traj.sort(key=lambda s: s.time_step)
    return Obstacle(
        obstacle_id=int(el.attrib["id"]),
        obstacle_type=(el.findtext("type") or "car").strip(),
        role=role,
        length=length,
        width=width,
        initial_state=init,
        trajectory=traj,
        shape_kind=kind,
    )


def _parse_planning_problem(el, lanelets) -> PlanningProblem:
    init = _parse_state(el.find("initialState"))
    goals = []
    for goal_el in el.findall("goalState"):
        g = GoalCondition()
        pos = goal_el.find("position")
        if pos is not None:
            g.position_lanelets = [int(l.attrib["ref"]) for l in pos.findall("lanelet")]
            rect = pos.find("rectangle")
            circ = pos.find("circle")
            poly = pos.find("polygon")
            point = pos.find("point")
            if rect is not None:
                length = float(rect.findtext("length"))
                width = float(rect.findtext("width"))
                c_el = rect.find("center")
                if c_el is not None:
                    cx = float(c_el.findtext("x"))
                    cy = float(c_el.findtext("y"))
                else:
                    cx = cy = 0.0
                o_el = rect.findtext("orientation")
                ang = float(o_el) if o_el else 0.0
                ca, sa = np.cos(ang), np.sin(ang)
                rot = np.array([[ca, -sa], [sa, ca]])
                half = np.array(
                    [[length, width], [length, -width], [-length, -width], [-length, width]]
                ) / 2.0
                g.position_shape = (half @ rot.T) + np.array([cx, cy])
            elif circ is not None:
                r = float(circ.findtext("radius"))
                c_el = circ.find("center")
                cx = float(c_el.findtext("x")) if c_el is not None else 0.0
                cy = float(c_el.findtext("y")) if c_el is not None else 0.0
                ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
                g.position_shape = np.stack(
                    [cx + r * np.cos(ang), cy + r * np.sin(ang)], axis=1
                )
            elif poly is not None:
                g.position_shape = _points(poly)
            elif point is not None:
                cx = float(point.findtext("x"))
                cy = float(point.findtext("y"))
                half = 0.25  # point goal → small square tolerance region
                g.position_shape = np.array([
                    [cx - half, cy - half], [cx + half, cy - half],
                    [cx + half, cy + half], [cx - half, cy + half],
                ])
        ti = _interval(goal_el, "time")
        if ti is not None:
            g.time_interval = (int(ti[0]), int(ti[1]))
        g.velocity_interval = _interval(goal_el, "velocity")
        g.orientation_interval = _interval(goal_el, "orientation")
        goals.append(g)
    return PlanningProblem(
        problem_id=int(el.attrib["id"]), initial_state=init, goals=goals
    )


def load_scenario(path: str) -> Scenario:
    """Parse a CommonRoad 2020a XML file."""
    tree = ET.parse(path)
    root = tree.getroot()
    dt = float(root.attrib.get("timeStepSize", "0.1"))
    scenario_id = root.attrib.get("benchmarkID", "unknown")

    lanelets = {}
    for el in root.findall("lanelet"):
        ll = _parse_lanelet(el)
        lanelets[ll.lanelet_id] = ll

    obstacles = {}
    for el in root.findall("dynamicObstacle"):
        ob = _parse_obstacle(el, "dynamic")
        obstacles[ob.obstacle_id] = ob
    for el in root.findall("staticObstacle"):
        ob = _parse_obstacle(el, "static")
        obstacles[ob.obstacle_id] = ob
    # legacy single-tag form
    for el in root.findall("obstacle"):
        role = (el.findtext("role") or "dynamic").strip().lower()
        ob = _parse_obstacle(el, role)
        obstacles[ob.obstacle_id] = ob

    problems = {}
    for el in root.findall("planningProblem"):
        pp = _parse_planning_problem(el, lanelets)
        problems[pp.problem_id] = pp

    signs = {}
    for el in root.findall("trafficSign"):
        ts = _parse_traffic_sign(el)
        signs[ts.sign_id] = ts
    lights = {}
    for el in root.findall("trafficLight"):
        tl = _parse_traffic_light(el)
        lights[tl.light_id] = tl
    intersections = [
        _parse_intersection(el)
        for el in root.findall("intersection")
        if el.find("incoming") is not None
    ]
    tags_el = root.find("scenarioTags")
    tags = [child.tag for child in tags_el] if tags_el is not None else []

    return Scenario(
        scenario_id=scenario_id,
        dt=dt,
        lanelets=lanelets,
        obstacles=obstacles,
        planning_problems=problems,
        traffic_signs=signs,
        traffic_lights=lights,
        intersections=intersections,
        tags=tags,
    )
