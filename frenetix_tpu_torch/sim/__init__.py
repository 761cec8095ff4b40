"""Multi-agent host simulation engine: the agents' loop, sequential or
batched, and the hand-over to the device-resident run."""

from frenetix_tpu_torch.sim.simulation import Simulation, SimulationResult  # noqa: F401
