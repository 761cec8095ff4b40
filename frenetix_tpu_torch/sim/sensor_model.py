"""Sensor model: which obstacles an agent sees.

Copy of `frenetix_tpu/sim/sensor_model.py` (pure NumPy; the JAX module sits
behind `frenetix_tpu.sim`, whose package import loads JAX): the radius filter,
the rear-cone filter, and the occlusion stage over the polar visible-area
model (`sim.visible_area`).
"""
from __future__ import annotations

import numpy as np

from frenetix_tpu_torch.sim.visible_area import compute_visible_area

__all__ = ["obstacles_in_radius", "filter_cone_angle", "visible_obstacles"]


def obstacles_in_radius(scenario, ego_id, ego_position, time_step, radius,
                        agent_ids=()):
    """IDs of obstacles with a state at `time_step` within `radius`."""
    out = []
    excluded = set(agent_ids) | {ego_id}
    for ob in scenario.obstacles.values():
        if ob.obstacle_id in excluded:
            continue
        st = ob.state_at_time(time_step)
        if st is None:
            continue
        if np.linalg.norm(np.asarray(st.position) - ego_position) < radius:
            out.append(ob.obstacle_id)
    return out


def filter_cone_angle(scenario, ids, ego_position, ego_orientation, time_step,
                      *, veh_length=4.508, cone_angle=20.0, cone_safety_dist=6.0):
    """Drop obstacles inside the rear cone behind the ego."""
    keep = []
    cone_rad = cone_angle * np.pi / 180.0
    c, s = np.cos(-ego_orientation), np.sin(-ego_orientation)
    for oid in ids:
        st = scenario.obstacles[oid].state_at_time(time_step)
        d = np.asarray(st.position) - ego_position
        loc = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]])
        loc[0] -= veh_length / 2.0
        dist = np.linalg.norm(loc)
        if loc[0] < 0 and dist > cone_safety_dist:
            ang = np.arctan2(loc[1], loc[0])
            if abs(abs(ang) - np.pi) < cone_rad / 2.0:
                continue
        keep.append(oid)
    return keep


def visible_obstacles(scenario, ego_id, ego_state, time_step, *, sensor_radius=50.0,
                      occlusions=True, cone_filter=True, veh_length=4.508,
                      cone_angle=20.0, cone_safety_dist=6.0, agent_ids=(),
                      return_area=False, road_segments=None, extra_occluders=()):
    """The sensor pipeline: radius → rear cone → visible-area occlusion
    (road-boundary walls and obstacle shadows,
    `sim.visible_area.compute_visible_area`).

    ego_state: object with .position and .orientation.  Returns the visible
    IDs (and the VisibleArea, None without the occlusion stage, when
    `return_area`)."""
    pos = np.asarray(ego_state.position, dtype=float)
    ids = obstacles_in_radius(
        scenario, ego_id, pos, time_step, sensor_radius, agent_ids
    )
    if cone_filter:
        ids = filter_cone_angle(
            scenario, ids, pos, ego_state.orientation, time_step,
            veh_length=veh_length, cone_angle=cone_angle,
            cone_safety_dist=cone_safety_dist,
        )
    if not occlusions:
        return (ids, None) if return_area else ids

    area = compute_visible_area(
        scenario, ego_id, pos, time_step, sensor_radius,
        agent_ids=agent_ids, road_segments=road_segments,
        extra_occluders=extra_occluders,
    )
    visible = []
    for oid in ids:
        ob = scenario.obstacles[oid]
        st = ob.state_at_time(time_step)
        if st is not None and area.obstacle_visible(
            st.position, st.orientation, ob.length, ob.width
        ):
            visible.append(oid)
    return (visible, area) if return_area else visible
