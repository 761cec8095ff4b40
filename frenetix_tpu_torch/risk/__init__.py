"""Risk and harm assessment: collision probabilities, injury-probability
models and the per-candidate risk aggregation."""

from frenetix_tpu_torch.risk.harm import (  # noqa: F401
    DEFAULT_HARM_COEFFS, ObstacleMeta, obstacle_mass, obstacle_protection,
)
from frenetix_tpu_torch.risk.costs import DEFAULT_RISK_MODES, trajectory_risks  # noqa: F401
