"""frenetix_tpu_torch — the PyTorch/CUDA port of frenetix_tpu for NVIDIA Hopper.

Laid out like the JAX package `frenetix_tpu`, which stays the reference:

- ``ops``       rollout, cost stack, collision checks, sampling matrices, and
                the hand-written CUDA kernel of the reference-table lookup
                (``csrc/``)
- ``geometry``  reference-path tables, drivable corridor, Frenet ↔ Cartesian
- ``planner``   the replanning cycle and the host planner around it
- ``parallel``  the agent axis: stacked contexts, the batched cycle, the
                batched stepper of the multi-agent simulation, the
                device-resident run and fleets, and the torch.distributed
                mesh that splits agents or scenarios over processes
- ``risk``      collision probabilities, harm models, per-candidate risks
- ``models``    Wale-Net prediction: the ONNX reader and its torch interpreter
- ``sim``       the host simulation loop (single- and multi-agent)
- ``io``        CommonRoad XML reader and the synthetic scenario families
- ``utils``     the configuration dataclasses

The package imports ``torch``, never ``jax`` and nothing of ``frenetix_tpu``:
it keeps its own copy of every host module it needs.  Entry points run on
the CUDA device unless the caller passes another ``torch.device``.
"""
import torch
import torch.distributed as dist

__version__ = "0.2.0"

__all__ = ["default_device"]


def default_device() -> torch.device:
    """The device the port's entry points use when the caller names none:
    the first CUDA device, or in a torch.distributed world the rank's own
    card (`parallel.distributed.initialize` made it the current device).
    Raises where there is none; the CPU is used only when a caller asks for
    it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "frenetix_tpu_torch runs on a CUDA device and none is available; "
            "pass torch.device('cpu') explicitly to run on the CPU")
    if dist.is_available() and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", 0)
