"""Occlusion-aware planning: phantom agents in occluded regions."""

from frenetix_tpu_torch.occlusion.occlusion_module import (  # noqa: F401
    PHANTOM_TYPES,
    OcclusionModule,
    PhantomSpec,
    PhantomThresholds,
    external_occlusion_costs,
    phantom_safety_mask,
)
