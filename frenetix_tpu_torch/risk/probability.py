"""Collision probabilities against Gaussian predictions, batched.

PyTorch port of `frenetix_tpu/risk/probability.py`:
  - `collision_probability_fast`: the ego occupancy approximated by 3
    axis-aligned rectangles × 3 obstacle means (center/front/back), the
    rectangle probability via the bivariate-normal CDF, a 5 m distance gate,
    a zero-covariance fallback to 0.1·I, the result divided by 3;
  - `inv_mahalanobis`: the 1/(Δᵀ Σ⁻¹ Δ)² surrogate;
  - `normalize_probability`: a piecewise-linear probability mapping.

The bivariate-normal CDF is a Drezner-style Gauss-Legendre quadrature over
the correlation parameter with 24 fixed nodes.

On a CUDA device `collision_probability_fast` prepares the per-(obstacle,
step) and per-(candidate, step) tensors and launches kernel Q
(`csrc/risk_quadrature.cu`) once: it tests each (agent, candidate, obstacle,
step) cell's slot and gate first and prices only the cells whose
probability can be non-zero.  On the CPU it runs the plain twin: eager
PyTorch materialises every temporary, so the quadrature loops over the
nodes and accumulates in place (a temporary then has the size of the query,
not 24 times it), the four rectangle corners go through one call, and the
candidates are walked in chunks of a bounded number of cells.

With `utils.tracing` on, the launch (or the chunk loop) is the device span
`frenetix.risk.quadrature`; the counter `risk.quadrature.cells` counts the
cells visited, and the device counter `risk.quadrature.useful` the cells
priced, those inside the gate of a valid slot (on the card Q counts them
itself).  Each launch of Q counts 1 on the host counter `kernel.q.launches`;
the plain twin's calls are not counted.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from frenetix_tpu_torch.ops import _kernels
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

# the nodes, then the weights, as kernel Q takes them
_GL_NODES = (ctypes.c_double * 48)(*_GL_X, *_GL_W)

# cells (rectangle × mean × agent × candidate × obstacle × step) per chunk of
# the plain twin; a chunk's largest temporary is 4 corners × this many
# elements
_MAX_CELLS = 1 << 22

_KERNEL = "risk_quadrature"
_ENTRY = {torch.float32: "risk_quadrature_f32", torch.float64: "risk_quadrature_f64"}

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


def _scales(cov):
    """(sx, sy, ρ) of covariances (..., 2, 2): the standard deviations
    (variances floored at 1e-12) and the correlation clamped to ±0.99."""
    sx = torch.sqrt(torch.clamp(cov[..., 0, 0], min=1e-12))
    sy = torch.sqrt(torch.clamp(cov[..., 1, 1], min=1e-12))
    rho = torch.clamp(cov[..., 0, 1] / (sx * sy), -0.99, 0.99)
    return sx, sy, rho


def rectangle_probability(lower, upper, mean, cov):
    """P(lower ≤ X ≤ upper) for 2-D normal X ~ N(mean, cov), broadcast.

    lower/upper/mean: (..., 2); cov: (..., 2, 2).  Inclusion-exclusion over
    the four corners of the standardized rectangle, evaluated in one
    `bvn_cdf` call."""
    sx, sy, rho = _scales(cov)
    a1 = (lower[..., 0] - mean[..., 0]) / sx
    a2 = (lower[..., 1] - mean[..., 1]) / sy
    b1 = (upper[..., 0] - mean[..., 0]) / sx
    b2 = (upper[..., 1] - mean[..., 1]) / sy
    a1, a2, b1, b2, rho = torch.broadcast_tensors(a1, a2, b1, b2, rho)
    c = bvn_cdf(torch.stack([b1, a1, b1, a1]), torch.stack([b2, b2, a2, a2]), rho)
    return torch.clamp(c[0] - c[1] - c[2] + c[3], 0.0, 1.0)


def _check(ro, preds):
    """Raise on inputs that neither path takes: tensors on different
    devices, floating tensors of another dtype than the rollout's, a
    non-bool validity mask; on a CUDA device a dtype other than float32 and
    float64, or leading prediction axes other than the rollout's (the twin
    takes no others either)."""
    floats = (ro.x, ro.y, ro.theta_gl, preds.means, preds.covs,
              preds.orientations, preds.lengths)
    device, dtype = ro.x.device, ro.x.dtype
    if any(t.device != device for t in floats + (preds.valid,)):
        raise ValueError(
            "collision_probability_fast: the rollout and the predictions must lie on "
            f"one device (got {sorted({str(t.device) for t in floats + (preds.valid,)})})")
    if any(t.dtype != dtype for t in floats):
        raise TypeError(
            "collision_probability_fast: the predictions' floating tensors must have "
            f"the rollout's dtype {dtype} (got {sorted({str(t.dtype) for t in floats})})")
    if preds.valid.dtype != torch.bool:
        raise TypeError("collision_probability_fast: preds.valid must be bool "
                        f"(got {preds.valid.dtype})")
    if device.type == "cpu":
        return
    if device.type != "cuda" or dtype not in _ENTRY:
        raise TypeError("collision_probability_fast: kernel Q takes float32 or float64 "
                        f"tensors on a CUDA device (got {dtype} on {device})")
    batch, pbatch = tuple(ro.x.shape[:-2]), tuple(preds.means.shape[:-3])
    if pbatch != batch:
        raise ValueError("collision_probability_fast: the predictions' leading axes "
                         f"{pbatch} are not the rollout's {batch}")


def _entry(dtype):
    fn = getattr(_kernels.load_library(_KERNEL), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_double] * 2 + [
            ctypes.POINTER(ctypes.c_double)] + [ctypes.c_longlong] * 4 + [
            ctypes.c_void_p] * 3
    return fn


def _means_and_covs(preds, t):
    """(means3 (3, ..., O, t, 2), cov (..., O, t, 2, 2)): each obstacle's
    centre, front and back mean points, and its covariances with the
    zero-covariance fallback, for prediction steps 0..t-1."""
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
    eye = torch.eye(2, dtype=cov.dtype, device=cov.device) * 0.1
    return means3, torch.where(cov_zero[..., None, None], eye, cov)


def _kernel_inputs(ro, preds, veh, t):
    """Kernel Q's inputs, contiguous: the three ego rectangle centres
    (3, B..., M, t, 2), the three obstacle means (3, B..., O, t, 2), and sx,
    sy, ρ and the slot mask (B..., O, t); computed as the plain twin computes
    them."""
    means3, cov = _means_and_covs(preds, t)
    off = (2.0 / 3.0) * (veh.length / 2.0)
    ego_xy = torch.stack([ro.x[..., 1 : t + 1], ro.y[..., 1 : t + 1]], dim=-1)
    ego_th = ro.theta_gl[..., 1 : t + 1]
    heading = torch.stack([torch.cos(ego_th), torch.sin(ego_th)], dim=-1)
    centers3 = torch.stack([ego_xy, ego_xy + off * heading, ego_xy - off * heading], dim=0)
    return (centers3, means3.contiguous(), *(x.contiguous() for x in _scales(cov)),
            preds.valid[..., :t].contiguous())


def _quadrature(centers3, means3, sx, sy, rho, valid, veh):
    """Kernel Q on `_kernel_inputs`: the (B..., M, O, t) result in one
    launch on the current stream."""
    device, dtype = centers3.device, centers3.dtype
    m, o, t = centers3.shape[-3], means3.shape[-3], centers3.shape[-2]
    out = torch.empty(sx.shape[:-2] + (m, o, t), dtype=dtype, device=device)
    tracing.count("risk.quadrature.cells", out.numel())
    if out.numel() == 0:
        return out
    # Q indexes cells and elements in 32 bits
    if max(out.numel() + 256, centers3.numel(), means3.numel()) > 1 << 32:
        raise ValueError(f"collision_probability_fast: {tuple(out.shape)} cells are more "
                         "than kernel Q indexes")
    useful = torch.zeros((), dtype=torch.int64, device=device) if tracing.enabled() else None
    fn = _entry(dtype)
    with torch.cuda.device(device), tracing.device_span("frenetix.risk.quadrature"):
        err = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (centers3, means3, sx, sy, rho,
                                                            valid)),
                 veh.length / 6.0, veh.width / 2.0, _GL_NODES, math.prod(sx.shape[:-2]),
                 m, o, t, ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(None if useful is None else useful.data_ptr()),
                 ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"risk_quadrature kernel launch failed: CUDA error {err}")
    tracing.count("kernel.q.launches", 1)
    if useful is not None:
        tracing.device_count("risk.quadrature.useful", useful)
    return out


def collision_probability_fast(ro, preds, veh, *, plain=False):
    """(prob_per_obstacle (..., M, O, t), t): collision probability per
    candidate, obstacle and step (3 ego rectangles × 3 obstacle means, 5 m
    gate, /3).  Output index j pairs ego step j+1 with prediction step j; the
    last prediction step is never used.  Leading agent axes of the rollout
    (..., M, N+1) and the predictions (..., O, T) ride along; the nine
    rectangle × mean terms are added one by one, so an agent's slice of a
    batched result equals its result alone.

    CUDA tensors (float32 or float64) go to kernel Q, one launch per call;
    CPU tensors, or any with `plain=True` (the card's tests and chip_smoke
    hold Q to it), to the plain twin.  Raises before either on tensors of
    mixed devices or dtypes (`_check`)."""
    _check(ro, preds)
    n1 = ro.x.shape[-1]
    t = min(n1 - 1, preds.horizon - 1)
    if ro.x.device.type == "cuda" and not plain:
        return _quadrature(*_kernel_inputs(ro, preds, veh, t), veh), t

    m, o = ro.x.shape[-2], preds.num_obstacles
    batch = tuple(ro.x.shape[:-2])
    dtype, device = ro.x.dtype, ro.x.device
    means3, cov = _means_and_covs(preds, t)
    off = (2.0 / 3.0) * (veh.length / 2.0)
    # two fills, not a host list: no host→device copy (CUDA-graph capture)
    offset = torch.full((2,), veh.length / 6.0, dtype=dtype, device=device)
    offset[1:].fill_(veh.width / 2.0)
    slot_valid = preds.valid[..., None, :, :t]
    valid = slot_valid.to(dtype)

    n_batch = int(np.prod(batch)) if batch else 1
    chunk = max(1, _MAX_CELLS // max(9 * o * t * n_batch, 1))
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
