"""The port's own copy of `frenetix_tpu/sim/world_view.py` (NumPy only).

Live world view for behavior planning in multi-agent simulations.

The behavior module's perception helpers (closest preceding vehicle,
obstacles-on-lanelet, stop-point clearance) read obstacle states per time
step.  In single-agent runs the scenario's recorded trajectories are the
ground truth; in multi-agent runs the dynamic obstacles have been CONVERTED
into planning agents, so their recorded trajectories are stale — the live
executed states must be observed instead.

The reference side-steps this by not supporting the combination at all
(behavior.yaml:2 "WARNING: Currently works only without multiagent!").  Here
`WorldView` presents one obstacle interface over both sources: scenario
obstacles that are NOT agents pass through; agents appear with their
executed state history (no state for future steps — live agents are only
observable up to "now", like the reference's ended trajectories).
"""
from __future__ import annotations

__all__ = ["WorldView", "attach_world_views"]


class _LiveAgentObstacle:
    """Obstacle facade over a planning agent's executed history."""

    def __init__(self, agent, length: float, width: float):
        self._agent = agent
        self.obstacle_id = agent.id
        self.obstacle_type = "car"
        self.role = "dynamic"
        self.length = length
        self.width = width

    def state_at_time(self, t: int):
        for s in reversed(self._agent.record.states):
            if s.time_step == t:
                return s
        return None


class WorldView:
    """Scenario-like obstacle access with live agents substituted in.

    Everything except obstacle access delegates to the scenario, so the
    behavior module can use a WorldView wherever it used the scenario.
    """

    def __init__(self, scenario, agents=(), exclude_id=None,
                 veh_length: float = 4.508, veh_width: float = 1.61):
        self._scenario = scenario
        agent_ids = {a.id for a in agents}
        self._live = {
            a.id: _LiveAgentObstacle(a, veh_length, veh_width)
            for a in agents if a.id != exclude_id
        }
        self._passthrough = {
            oid: ob for oid, ob in scenario.obstacles.items()
            if oid not in agent_ids
        }

    # ------------------------------------------------------ obstacle access
    @property
    def obstacles(self) -> dict:
        out = dict(self._passthrough)
        out.update(self._live)
        return out

    @property
    def dynamic_obstacles(self) -> list:
        return [o for o in self._passthrough.values() if o.role == "dynamic"] \
            + list(self._live.values())

    # -------------------------------------------------- scenario delegation
    def __getattr__(self, name):
        return getattr(self._scenario, name)


def attach_world_views(simulation) -> None:
    """Give every behavior-enabled agent a live world view over its peers."""
    for a in simulation.agents:
        if a.behavior is not None:
            a.behavior.bm.world = WorldView(
                simulation.scenario, simulation.agents, exclude_id=a.id,
                veh_length=simulation.config.vehicle.length,
                veh_width=simulation.config.vehicle.width,
            )
