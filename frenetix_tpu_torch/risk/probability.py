"""Collision probabilities against Gaussian predictions, batched.

PyTorch port of `frenetix_tpu/risk/probability.py`:
  - `collision_probability_fast`: the ego occupancy approximated by 3
    axis-aligned rectangles × 3 obstacle means (center/front/back), the
    rectangle probability via the bivariate-normal CDF, a 5 m distance gate,
    a zero-covariance fallback to 0.1·I, the result divided by 3;
  - `inv_mahalanobis`: the 1/(Δᵀ Σ⁻¹ Δ)² surrogate;
  - `normalize_probability`: a piecewise-linear probability mapping.

The bivariate-normal CDF is a Drezner-style Gauss-Legendre quadrature over
the correlation parameter with 24 fixed nodes.  Eager PyTorch materialises
every temporary, so the quadrature loops over the nodes and accumulates in
place (a temporary then has the size of the query, not 24 times it), the
four rectangle corners go through one call, and
`collision_probability_fast` walks the candidates in chunks of a bounded
number of cells.  With `utils.tracing` on, the chunk loop is the device span
`frenetix.risk.quadrature`; the counter `risk.quadrature.cells` counts the
(agent, candidate, obstacle, step) cells it evaluates, and the device
counter `risk.quadrature.useful` those inside the gate of a valid slot, the
only ones whose probability can be non-zero.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from frenetix_tpu_torch.ops.costs import quadratic_form_2x2
from frenetix_tpu_torch.utils import tracing

__all__ = [
    "bvn_cdf",
    "rectangle_probability",
    "collision_probability_fast",
    "inv_mahalanobis",
    "normalize_probability",
]

# 24-point Gauss-Legendre nodes/weights on [0, 1]
_GL_X, _GL_W = np.polynomial.legendre.leggauss(24)
_GL_X = ((_GL_X + 1.0) / 2.0).tolist()
_GL_W = (_GL_W / 2.0).tolist()

# cells (rectangle × mean × agent × candidate × obstacle × step) per chunk of
# `collision_probability_fast`; a chunk's largest temporary is 4 corners ×
# this many elements.  On the card a chunk costs a whole pass of kernel
# launches and memory is plentiful, so the bound is 16 times the host's: a
# batch of 8 agents × 1024 candidates × 16 obstacles is one chunk there.
_MAX_CELLS = 1 << 22
_MAX_CELLS_CUDA = 1 << 26

# (ego rectangle, obstacle mean) pairs in the order their terms are added
_RECT_MEAN_PAIRS = [(r, k) for r in range(3) for k in range(3)]


def bvn_cdf(x, y, rho):
    """Standard bivariate normal CDF Φ₂(x, y, ρ), elementwise and broadcast.

    Φ₂ = Φ(x)Φ(y) + 1/(2π) ∫₀^ρ exp(-(x²-2rxy+y²)/(2(1-r²)))/√(1-r²) dr with
    fixed Gauss-Legendre quadrature (~1e-7 absolute accuracy for |ρ| ≤ 0.99);
    Φ is `torch.special.ndtr`."""
    x, y, rho = torch.broadcast_tensors(*(torch.as_tensor(v) for v in (x, y, rho)))
    acc = torch.zeros_like(x)
    for node, weight in zip(_GL_X, _GL_W):
        r = rho * node
        one_m_r2 = 1.0 - r * r
        acc += torch.exp(
            -(x * x - 2.0 * r * x * y + y * y) / (2.0 * one_m_r2)
        ) / torch.sqrt(one_m_r2) * weight
    integral = acc * rho
    return torch.special.ndtr(x) * torch.special.ndtr(y) + integral / (2.0 * math.pi)


def rectangle_probability(lower, upper, mean, cov):
    """P(lower ≤ X ≤ upper) for 2-D normal X ~ N(mean, cov), broadcast.

    lower/upper/mean: (..., 2); cov: (..., 2, 2).  Inclusion-exclusion over
    the four corners of the standardized rectangle, evaluated in one
    `bvn_cdf` call."""
    sx = torch.sqrt(torch.clamp(cov[..., 0, 0], min=1e-12))
    sy = torch.sqrt(torch.clamp(cov[..., 1, 1], min=1e-12))
    rho = torch.clamp(cov[..., 0, 1] / (sx * sy), -0.99, 0.99)
    a1 = (lower[..., 0] - mean[..., 0]) / sx
    a2 = (lower[..., 1] - mean[..., 1]) / sy
    b1 = (upper[..., 0] - mean[..., 0]) / sx
    b2 = (upper[..., 1] - mean[..., 1]) / sy
    a1, a2, b1, b2, rho = torch.broadcast_tensors(a1, a2, b1, b2, rho)
    c = bvn_cdf(torch.stack([b1, a1, b1, a1]), torch.stack([b2, b2, a2, a2]), rho)
    return torch.clamp(c[0] - c[1] - c[2] + c[3], 0.0, 1.0)


def collision_probability_fast(ro, preds, veh):
    """(prob_per_obstacle (..., M, O, t), t): collision probability per
    candidate, obstacle and step (3 ego rectangles × 3 obstacle means, 5 m
    gate, /3).  Output index j pairs ego step j+1 with prediction step j; the
    last prediction step is never used.  Leading agent axes of the rollout
    (..., M, N+1) and the predictions (..., O, T) ride along; the nine
    rectangle × mean terms are added one by one, so an agent's slice of a
    batched result equals its result alone."""
    n1 = ro.x.shape[-1]
    t = min(n1 - 1, preds.horizon - 1)
    m, o = ro.x.shape[-2], preds.num_obstacles
    batch = tuple(ro.x.shape[:-2])
    dtype, device = ro.x.dtype, ro.x.device

    mean_c = preds.means[..., :t, :]  # (..., O, t, 2)
    # the front/back mean points of prediction step j use the orientation of
    # step j+1 (a one-step yaw offset the JAX package pins against its source)
    yaw = preds.orientations[..., 1 : t + 1]
    half_len_vec = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1) * (
        preds.lengths[..., None, None] / 2.0
    )
    means3 = torch.stack(
        [mean_c, mean_c + half_len_vec, mean_c - half_len_vec], dim=0
    )  # (3, ..., O, t, 2)

    cov = preds.covs[..., :t, :, :]  # (..., O, t, 2, 2)
    # zero covariance (ground truth) falls back to 0.1·I
    cov_zero = torch.all((torch.abs(cov) < 1e-12).flatten(-2), dim=-1)
    eye = torch.eye(2, dtype=cov.dtype, device=device) * 0.1
    cov = torch.where(cov_zero[..., None, None], eye, cov)

    off = (2.0 / 3.0) * (veh.length / 2.0)
    # two fills, not a host list: no host→device copy (CUDA-graph capture)
    offset = torch.full((2,), veh.length / 6.0, dtype=dtype, device=device)
    offset[1:].fill_(veh.width / 2.0)
    slot_valid = preds.valid[..., None, :, :t]
    valid = slot_valid.to(dtype)

    n_batch = int(np.prod(batch)) if batch else 1
    max_cells = _MAX_CELLS_CUDA if device.type == "cuda" else _MAX_CELLS
    chunk = max(1, max_cells // max(9 * o * t * n_batch, 1))
    out = torch.empty(batch + (m, o, t), dtype=dtype, device=device)
    with tracing.device_span("frenetix.risk.quadrature"):
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            ego_xy = torch.stack([ro.x[..., lo:hi, 1 : t + 1], ro.y[..., lo:hi, 1 : t + 1]],
                                 dim=-1)                                # (..., m, t, 2)
            ego_th = ro.theta_gl[..., lo:hi, 1 : t + 1]

            # 5 m distance gate on the minimum of the three mean distances
            delta = means3.unsqueeze(-4) - ego_xy.unsqueeze(-3)[None]  # (3, ..., m, O, t, 2)
            dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
            gate = torch.amin(dist, dim=0) <= 5.0  # (..., m, O, t)
            tracing.count("risk.quadrature.cells", gate.numel())
            if tracing.enabled():
                tracing.device_count("risk.quadrature.useful",
                                     (gate & slot_valid).sum())

            # 3 axis-aligned ego rectangles: centers at 0, ±(2/3)(l/2) along heading
            heading = torch.stack([torch.cos(ego_th), torch.sin(ego_th)], dim=-1)
            centers3 = torch.stack(
                [ego_xy, ego_xy + off * heading, ego_xy - off * heading], dim=0
            )  # (3, ..., m, t, 2)
            lower3 = centers3 - offset
            upper3 = centers3 + offset

            # broadcast: rect r (3) × mean (3) × (..., m, O, t)
            p = rectangle_probability(
                lower3.unsqueeze(1).unsqueeze(-3),     # (3, 1, ..., m, 1, t, 2)
                upper3.unsqueeze(1).unsqueeze(-3),
                means3[None].unsqueeze(-4),            # (1, 3, ..., 1, O, t, 2)
                cov.unsqueeze(-5)[None, None],         # (1, 1, ..., 1, O, t, 2, 2)
            )  # (3, 3, ..., m, O, t)
            prob = p[0, 0]
            for r, k in _RECT_MEAN_PAIRS[1:]:
                prob = prob + p[r, k]
            out[..., lo:hi, :, :] = prob / 3.0 * gate.to(dtype) * valid
    return out, t


def inv_mahalanobis(ro, preds):
    """(..., M, O, t) inverse-Mahalanobis surrogate; index j pairs ego step
    j+1 with prediction step j."""
    n1 = ro.x.shape[-1]
    t = min(n1 - 1, preds.horizon - 1)
    mean = preds.means[..., None, :, :t, :]
    icov = preds.inv_covs[..., None, :, :t, :, :]
    dx = ro.x[..., :, None, 1 : t + 1] - mean[..., 0]
    dy = ro.y[..., :, None, 1 : t + 1] - mean[..., 1]
    md2 = quadratic_form_2x2(dx, dy, icov)
    out = 1.0 / torch.clamp(md2 * md2, min=1e-12)
    return out * preds.valid[..., None, :, :t].to(out.dtype), t


def normalize_probability(prob):
    """Piecewise-linear probability normalization; the first matching
    threshold from the top wins, anything at or below 1e-70 maps to 0.001."""
    pieces = [
        (1e-1, 0.6666666666666666, 0.33333333333333337),
        (1e-2, 1.1111111111111114, 0.28888888888888886),
        (1e-4, 10.101010101010099, 0.198989898989899),
        (1e-10, 1000.001000001, 0.0999998999999),
        (1e-70, 900000000.0000001, 0.01),
    ]
    out = torch.full_like(prob, 0.001)
    for threshold, slope, intercept in reversed(pieces):
        out = torch.where(prob > threshold, slope * prob + intercept, out)
    return out
