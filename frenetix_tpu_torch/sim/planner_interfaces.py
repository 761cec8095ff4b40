"""The behavior output's hand-over to an agent's planner.

PyTorch port of `frenetix_tpu/sim/planner_interfaces.py::apply_behavior_output`.
The interface registry of that module is not ported; the port's `Agent` keeps
the default interface inlined.
"""
from __future__ import annotations

__all__ = ["apply_behavior_output"]


def apply_behavior_output(agent, b_out) -> bool:
    """Apply one BehaviorOutput to an agent's planner: the single place of
    the reference-path swap, the curvilinear reset, the rear-axle shift of
    the stop point and the desired velocity (the sequential agent, the
    batched stepper and the hybrid device run all call it).

    Returns True if the reference path was (re)installed by this call."""
    a = agent
    swapped = False
    if b_out.reference_path is not None \
            and b_out.reference_path is not getattr(a, "_applied_ref_path", None):
        # lane change: new coordinate system, curvilinear state recomputed on
        # the new path; the identity guard skips the rebuild when a cached
        # output of this step is applied again
        a.planner.set_reference_path(
            b_out.reference_path, a.scenario.drivable_polygons(),
            lanelets=list(a.scenario.lanelets.values())
            if a.config.cost_weights.get("lane_center_offset", 0) != 0
            else None,
        )
        a._applied_ref_path = b_out.reference_path
        a.x_cl = None
        a._goal_s = a._compute_goal_s()
        swapped = True
    a.ensure_x_cl()
    a.planner.set_desired_velocity(b_out.desired_velocity)
    # behavior stop points are vehicle-center s, the planner's curvilinear
    # state is rear-axle s
    a.planner.set_stop_point(
        None if b_out.stop_point_s is None
        else b_out.stop_point_s - a.veh.wb_rear_axle,
        b_out.desired_velocity_stop_point,
    )
    return swapped
