"""Host-side scenario ingestion (CommonRoad XML reader, synthetic scenarios)."""

from frenetix_tpu_torch.io.commonroad import Scenario, load_scenario  # noqa: F401
