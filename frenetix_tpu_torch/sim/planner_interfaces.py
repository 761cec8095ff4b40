"""Planner-interface plugin registry and the behavior output's hand-over.

PyTorch port of `frenetix_tpu/sim/planner_interfaces.py`: any registered
`PlannerInterface` subclass is selectable by class name through
`config.simulation.used_planner_interface`, so another planner can drop in
without touching the Agent lifecycle.  `FrenetPlannerInterface` is the
default: it feeds the agent's planner per replan (predictions, obstacles,
reach-set grids, desired velocity, the behavior output) and runs
`ReactivePlanner.plan`.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

__all__ = [
    "PLANNER_INTERFACES",
    "FrenetPlannerInterface",
    "PlannerInterface",
    "apply_behavior_output",
    "get_planner_interface",
    "register_planner_interface",
]

PLANNER_INTERFACES: dict = {}


def register_planner_interface(cls):
    """Class decorator: registers the class under its name."""
    PLANNER_INTERFACES[cls.__name__] = cls
    return cls


def get_planner_interface(name: str):
    if name not in PLANNER_INTERFACES:
        raise KeyError(
            f"unknown planner interface {name!r}; registered: "
            f"{sorted(PLANNER_INTERFACES)}"
        )
    return PLANNER_INTERFACES[name]


class PlannerInterface(ABC):
    """Adapter between the Agent lifecycle and a planner implementation."""

    def __init__(self, agent):
        self.agent = agent

    @abstractmethod
    def update_planner(self, predictions, obstacle_xy, obstacle_valid):
        """Feed per-cycle external information into the planner."""

    @abstractmethod
    def step_interface(self):
        """Run one replanning cycle; returns the selected plan or None."""


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


@register_planner_interface
class FrenetPlannerInterface(PlannerInterface):
    """Default interface: the agent's ReactivePlanner on its device."""

    def update_planner(self, predictions, obstacle_xy, obstacle_valid):
        """Feed one cycle's predictions, obstacles and desired velocity; with
        a behavior module its output (velocity, stop point, reference path)."""
        a = self.agent
        a.planner.set_predictions(predictions)
        a.planner.set_obstacles(obstacle_xy, obstacle_valid)
        if a.config.cost_weights.get("responsibility", 0.0) != 0.0 \
                and predictions is not None:
            a.planner.set_reach_grid(a.reach_grid_for(predictions))
        if a.behavior is not None:
            b_out = a.behavior.execute(predictions, a.state, a.state.time_step)
            apply_behavior_output(a, b_out)
        else:
            a.ensure_x_cl()  # desired_velocity() projects the goal against x_cl
            a.planner.set_desired_velocity(a.desired_velocity())

    def step_interface(self):
        a = self.agent
        return a.planner.plan(a._rear_axle_state(), a.ensure_x_cl())
