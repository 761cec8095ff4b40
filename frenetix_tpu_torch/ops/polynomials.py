"""Batched quartic/quintic polynomial trajectories (closed form, no solver).

PyTorch port of `frenetix_tpu/ops/polynomials.py`: the same closed-form
coefficient solves and Horner evaluations, elementwise over any batch shape.
"""
from __future__ import annotations

import torch

__all__ = [
    "quartic_coeffs",
    "quintic_coeffs",
    "poly_position",
    "poly_velocity",
    "poly_acceleration",
    "poly_jerk",
    "squared_jerk_integral",
]


def quartic_coeffs(xs, vxs, axs, v_target, T):
    """Coefficients [a0..a5] (a5 = 0) of the end-velocity-constrained quartic:
    a3 = c1/T² - c2/(3T), a4 = -c1/(2T³) + c2/(4T²) with
    c1 = v_target - vxs - axs·T, c2 = -axs.  Returns (..., 6)."""
    xs, vxs, axs, v_target, T = torch.broadcast_tensors(xs, vxs, axs, v_target, T)
    c1 = v_target - vxs - axs * T
    c2 = -axs
    invT = 1.0 / T
    invT2 = invT * invT
    a3 = c1 * invT2 - c2 * (invT / 3.0)
    a4 = -0.5 * c1 * invT2 * invT + 0.25 * c2 * invT2
    return torch.stack([xs, vxs, 0.5 * axs, a3, a4, torch.zeros_like(T)], dim=-1)


def quintic_coeffs(xs, vxs, axs, xe, vxe, axe, T):
    """Coefficients [a0..a5] of the fully end-state-constrained quintic
    (closed form of the 3×3 system).  Returns (..., 6)."""
    xs, vxs, axs, xe, vxe, axe, T = torch.broadcast_tensors(
        xs, vxs, axs, xe, vxe, axe, T)
    T2 = T * T
    b0 = xe - xs - vxs * T - 0.5 * axs * T2
    b1 = vxe - vxs - axs * T
    b2 = axe - axs
    invT = 1.0 / T
    invT2 = invT * invT
    invT3 = invT2 * invT
    a3 = 0.5 * (20.0 * b0 - 8.0 * b1 * T + b2 * T2) * invT3
    a4 = 0.5 * (-30.0 * b0 + 14.0 * b1 * T - 2.0 * b2 * T2) * invT3 * invT
    a5 = 0.5 * (12.0 * b0 - 6.0 * b1 * T + b2 * T2) * invT3 * invT2
    return torch.stack([xs, vxs, 0.5 * axs, a3, a4, a5], dim=-1)


def _coeffs(coeffs, lo, hi):
    return (coeffs[..., i : i + 1] for i in range(lo, hi))


def poly_position(coeffs, tau):
    """p(τ) for coeffs (..., 6) and τ (..., N), Horner scheme."""
    a0, a1, a2, a3, a4, a5 = _coeffs(coeffs, 0, 6)
    return a0 + tau * (a1 + tau * (a2 + tau * (a3 + tau * (a4 + tau * a5))))


def poly_velocity(coeffs, tau):
    """dp/dτ."""
    a1, a2, a3, a4, a5 = _coeffs(coeffs, 1, 6)
    return a1 + tau * (2.0 * a2 + tau * (3.0 * a3 + tau * (4.0 * a4 + tau * 5.0 * a5)))


def poly_acceleration(coeffs, tau):
    """d²p/dτ²."""
    a2, a3, a4, a5 = _coeffs(coeffs, 2, 6)
    return 2.0 * a2 + tau * (6.0 * a3 + tau * (12.0 * a4 + tau * 20.0 * a5))


def poly_jerk(coeffs, tau):
    """d³p/dτ³."""
    a3, a4, a5 = _coeffs(coeffs, 3, 6)
    return 6.0 * a3 + tau * (24.0 * a4 + tau * 60.0 * a5)


def squared_jerk_integral(coeffs, t):
    """∫₀ᵗ jerk(τ)² dτ in closed form; coeffs (..., 6), t broadcastable."""
    a3 = coeffs[..., 3]
    a4 = coeffs[..., 4]
    a5 = coeffs[..., 5]
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    t5 = t4 * t
    return (
        36.0 * a3 * a3 * t
        + 144.0 * a3 * a4 * t2
        + (240.0 * a3 * a5 + 192.0 * a4 * a4) * t3
        + 720.0 * a4 * a5 * t4
        + 720.0 * a5 * a5 * t5
    )
