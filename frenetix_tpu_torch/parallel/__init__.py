"""The agent and scenario axes: the batched cycle, the device-resident run
and fleets, and the torch.distributed mesh that splits them over processes."""

from frenetix_tpu_torch.parallel.mesh import (  # noqa: F401
    agent_pose_predictions,
    batched_full_cycle,
    concat_obstacles,
    make_agent_mesh,
    sharded_full_cycle,
    stack_cycle_contexts,
)
from frenetix_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize as distributed_initialize,
    shard_scenarios,
)
from frenetix_tpu_torch.parallel.device_sim import (  # noqa: F401
    DeviceSimResult,
    DeviceSimulation,
    FleetRunner,
    run_fleet,
)
