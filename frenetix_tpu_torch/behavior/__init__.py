"""The port's own copy of `frenetix_tpu/behavior/__init__.py` (NumPy only).

Behavior planning: hierarchical FSM, path planner (reference-path
modification for lane changes), static route plan, TTC/MAX velocity planning,
stop points.  Mirrors the reference's behavior_planner/."""

from frenetix_tpu_torch.behavior.behavior_module import (  # noqa: F401
    BehaviorModule, BehaviorOutput, BMState,
)
from frenetix_tpu_torch.behavior.fsm import EgoFSM, FSMState  # noqa: F401
from frenetix_tpu_torch.behavior.static_route import (  # noqa: F401
    StaticGoal, build_static_route_plan,
)
from frenetix_tpu_torch.behavior.velocity_planner import VelocityPlanner  # noqa: F401
from frenetix_tpu_torch.behavior.path_planner import PathPlanner  # noqa: F401
