"""The replanning cycle and the host planner around it."""
