"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; outputs
come back as numpy arrays and are compared field by field.
"""
from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")

# Float fields: relative 1e-9 of the value, plus an absolute floor of 1e-10
# for entries that are zero on one side and round-off (~1e-16 of the
# neighbouring magnitudes) on the other.
RTOL = 1e-9
ATOL = 1e-10


def to_np(x):
    """numpy view of a torch tensor, a JAX array or a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t64(a):
    """float64 CPU tensor (bool arrays stay bool)."""
    a = np.array(a)
    if a.dtype == bool:
        return torch.as_tensor(a)
    return torch.as_tensor(a, dtype=torch.float64)


def assert_fields_match(jax_tuple, torch_tuple, fields=None, rtol=RTOL, atol=ATOL,
                        what=""):
    """Bool and integer fields equal, float fields within (rtol, atol);
    tuples of arrays (the rollout's `extras`) are compared entry by entry."""
    for f in fields or jax_tuple._fields:
        a, b = getattr(jax_tuple, f), getattr(torch_tuple, f)
        if a is None or b is None:
            assert a is None and b is None, f"{what}{f}: one side is None"
            continue
        if isinstance(a, tuple):
            a, b = np.stack([to_np(x) for x in a]), np.stack([to_np(x) for x in b])
        a, b = to_np(a), to_np(b)
        assert a.shape == b.shape, f"{what}{f}: shape {a.shape} vs {b.shape}"
        if a.dtype == bool or a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}{f}")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{what}{f}")


def curved_ref_np(n_points=600, radius=150.0, dtype=np.float64):
    """The bench's 60° arc (R = 868 rows at ds ≈ 0.25 m, above the 768-row
    window of the cycle)."""
    from frenetix_tpu.geometry.refpath import prepare_reference_path

    t = np.linspace(0, np.pi / 3, n_points)
    center = np.stack([radius * np.sin(t), radius * (1 - np.cos(t))], axis=1)
    return prepare_reference_path(center, extension=30.0, dtype=dtype)


def ref_to_torch(ref_np, dtype=torch.float64):
    return type(ref_np)(*(torch.as_tensor(np.array(f), dtype=dtype) for f in ref_np))


def torch_rollout(jro):
    """The port's Rollout carrying a JAX rollout's values (float64, CPU)."""
    from frenetix_tpu_torch.ops.kinematics import Rollout

    fields = {}
    for f in jro._fields:
        v = getattr(jro, f)
        if f == "extras":
            fields[f] = tuple(t64(x) for x in v) if v is not None else None
        elif f == "traj_len":
            fields[f] = torch.as_tensor(np.array(v))
        else:
            fields[f] = t64(v)
    return Rollout(**fields)
