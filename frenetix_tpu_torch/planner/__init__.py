"""The replanning cycle and the host planner around it."""

from frenetix_tpu_torch.planner.core import CycleContext, CycleResult, evaluate_cycle  # noqa: F401
