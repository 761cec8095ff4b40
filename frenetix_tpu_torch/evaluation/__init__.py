"""Post-hoc evaluation: criticality metrics, the solution check, solution
XML with its benchmark cost, and collision reports."""

from frenetix_tpu_torch.evaluation.metrics import CRITICALITY_METRICS, Measures  # noqa: F401
from frenetix_tpu_torch.evaluation.evaluate import evaluate_simulation  # noqa: F401
