"""frenetix_tpu_torch — the PyTorch/CUDA port of frenetix_tpu for NVIDIA Hopper.

Laid out like the JAX package `frenetix_tpu`, which stays the reference:

- ``ops``       rollout, cost stack, collision checks, and the hand-written
                CUDA kernel of the reference-table lookup (``csrc/``)
- ``geometry``  Frenet ↔ Cartesian conversions against reference tables
- ``planner``   the replanning cycle and the host planner around it
- ``sim``       the single-agent host simulation loop
- ``utils``     the configuration dataclasses

Every entry point takes a ``torch.device``; tensors follow it.  The package
imports ``torch`` and never ``jax``; it reuses the JAX-free host modules of
``frenetix_tpu`` (reference-path preprocessing, corridor, sampling, scenario
I/O) by import.
"""

__version__ = "0.1.0"
