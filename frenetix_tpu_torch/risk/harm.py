"""Injury-probability (harm) models, vectorized over (M, O, T) tensors.

PyTorch port of `frenetix_tpu/risk/harm.py`: the harm-model dispatch by the
risk modes (harm_mode ∈ {log_reg, ref_speed, gidas} × {ignore, sym, reduced}
angle handling), the obstacle protection table, the obstacle masses, and the
per-model formulas with their published MAIS3+/MAIS2+ regression
coefficients.  Impact angles are wrapped into ]-π, π] before area binning in
every variant.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DEFAULT_HARM_COEFFS",
    "ObstacleMeta",
    "meta_from_footprint",
    "meta_from_numpy",
    "obstacle_protection",
    "obstacle_mass",
    "angle_range",
    "log_reg_harm",
    "ref_speed_harm",
    "gidas_harm",
    "pedestrian_harm",
]

# published regression coefficients of the harm models
DEFAULT_HARM_COEFFS = {
    "log_reg": {
        "complete_angle_areas": {
            "const": -4.626, "speed": 0.189,
            "imp": [-0.039, 0.018, 0.459, -0.125, -1.413, -0.116, -1.782,
                    -0.434, 0.482, 0.142, 0.400],  # Imp_1..Imp_11 (Imp_12 = 0)
        },
        "reduced_angle_areas": {
            "const": -4.476, "speed": 0.179,
            "driver_side": 0.250, "right_side": 0.259, "rear": -0.445,
        },
        "ignore_angle": {"const": -4.591, "speed": 0.185},
        "complete_sym_angle_areas": {
            "const": -4.620, "speed": 0.189,
            "imp": [0.209, 0.086, 0.470, -0.259, -1.590, -0.118],  # 1_11..6
        },
        "reduced_sym_angle_areas": {
            "const": -4.457, "speed": 0.177, "side": 0.244, "rear": -0.431,
        },
    },
    "ref_speed": {
        "complete_angle_areas": {
            "speeds": [52.886, 51.995, 39.992, 56.450, 107.092, 52.623,
                       123.535, 68.055, 40.475, 47.301, 42.249, 48.666],
            "exp": 1.592,
        },
        "reduced_angle_areas": {
            "front": 51.285, "right_side": 46.452, "rear": 66.953,
            "driver_side": 47.115, "exp": 1.531,
        },
        "ignore_angle": {"ref_speed": 51.144, "exp": 1.570},
        "complete_sym_angle_areas": {
            "speeds": [46.717, 49.427, 40.298, 61.349, 115.139, 52.787, 48.783],
            "exp": 1.589,
        },
        "reduced_sym_angle_areas": {
            "front": 51.287, "side": 46.774, "rear": 66.956, "exp": 1.531,
        },
    },
    "gidas": {"const": -5.820, "speed": 0.292},
    "pedestrian": {"const": 3.164, "speed": 0.288},
    "pedestrian_MAIS2+": {"const": 1.786, "speed": 0.259},
}

# protection by CommonRoad obstacle type
_PROTECTION = {
    "car": 1, "truck": 1, "bus": 1, "priorityVehicle": 1, "parkedVehicle": 1,
    "train": 1, "taxi": 1,
    "bicycle": 0, "pedestrian": 0, "motorcycle": 0, "unknown": 0,
    "roadBoundary": -1, "pillar": -1, "constructionZone": -1, "building": -1,
    "medianStrip": -1,
}


def obstacle_protection(obstacle_type: str) -> int:
    """1 = protective crash structure, 0 = unprotected, -1 = static structure."""
    return _PROTECTION.get(obstacle_type, 0)


def obstacle_mass(obstacle_type: str, size: float) -> float:
    """Estimated obstacle mass [kg] from its type and footprint area."""
    if obstacle_type in ("car", "priorityVehicle", "parkedVehicle", "taxi"):
        return -1333.5 + 526.9 * size**0.8
    return {
        "truck": 25000.0, "bus": 13000.0, "bicycle": 90.0, "pedestrian": 75.0,
        "train": 118800.0, "motorcycle": 250.0,
    }.get(obstacle_type, 0.0)


class ObstacleMeta(NamedTuple):
    """Per-obstacle crash metadata (padded (O,) tensors)."""

    mass: torch.Tensor       # (O,)
    protected: torch.Tensor  # (O,) int32: 1 protected, 0 unprotected, -1 structure

    @staticmethod
    def from_obstacles(obstacles, max_obstacles: int, device: torch.device,
                       dtype=torch.float32):
        mass = np.zeros(max_obstacles, np.float64)
        prot = np.ones(max_obstacles, np.int32)
        for k, ob in enumerate(obstacles[:max_obstacles]):
            prot[k] = obstacle_protection(ob.obstacle_type)
            mass[k] = obstacle_mass(ob.obstacle_type, ob.length * ob.width)
        return meta_from_numpy(mass, prot, device=device, dtype=dtype)


def meta_from_numpy(mass, protected, *, device: torch.device,
                    dtype=torch.float64) -> ObstacleMeta:
    """The port's ObstacleMeta from the leaves of a JAX ObstacleMeta as NumPy
    arrays (or anything `np.asarray` takes)."""
    return ObstacleMeta(
        mass=torch.as_tensor(np.array(mass), dtype=dtype, device=device),
        protected=torch.as_tensor(np.array(protected).astype(np.int32),
                                  device=device),
    )


def meta_from_footprint(lengths, widths) -> ObstacleMeta:
    """Crash metadata inferred from the footprint area when obstacle types
    are not available in the tensor path.  A pedestrian-sized box (< 0.6 m²)
    is an unprotected 75 kg body, bicycle-sized (< 1.4 m²) 90 kg,
    motorcycle-sized 250 kg; anything ≥ 2.5 m² gets the protected car-class
    regression.  Computed on the device of `lengths`, in its dtype."""
    size = lengths * widths
    protected = size >= 2.5
    car = -1333.5 + 526.9 * torch.clamp(size, min=1.0) ** 0.8
    unprot = torch.full_like(size, 250.0)
    unprot = torch.where(size < 1.4, 90.0, unprot)
    unprot = torch.where(size < 0.6, 75.0, unprot)
    mass = torch.where(protected, car, unprot)
    return ObstacleMeta(mass=mass, protected=protected.to(torch.int32))


def angle_range(angle):
    """Wrap into ]-π, π] (the result of the floored modulo at exactly -π
    becomes +π)."""
    wrapped = torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(wrapped == -math.pi, math.pi, wrapped)


def _select(conds, vals, default):
    """The value of the first true condition, else `default` (np.select)."""
    out = default
    for cond, val in zip(reversed(conds), reversed(vals)):
        out = torch.where(cond, val, out)
    return out


_DEG = math.pi / 180.0


def _sym_area_coeff(angle, imp6):
    """Angle-area coefficient of the 12-area symmetric model: bins of |angle|
    in 30° sectors; imp6 = [Imp_1_11, ..., Imp_6] plus an implicit 0 for the
    frontal sector (impact 12)."""
    a = torch.abs(angle_range(angle))
    bins = [
        a < 15 * _DEG,                          # impact 12 → 0
        (a >= 15 * _DEG) & (a < 45 * _DEG),     # 1 / 11
        (a >= 45 * _DEG) & (a < 75 * _DEG),     # 2 / 10
        (a >= 75 * _DEG) & (a < 105 * _DEG),    # 3 / 9
        (a >= 105 * _DEG) & (a < 135 * _DEG),   # 4 / 8
        (a >= 135 * _DEG) & (a < 165 * _DEG),   # 5 / 7
    ]
    vals = [torch.zeros_like(a)] + [torch.full_like(a, c) for c in imp6[:5]]
    return _select(bins, vals, torch.full_like(a, imp6[5]))


def _quadrants(angle):
    """(front, left side, right side) masks of the 4-area models."""
    a = angle_range(angle)
    t_a = math.pi / 4.0
    t_b = 3.0 * t_a
    front = (a > -t_a) & (a < t_a)
    left = (a >= t_a) & (a < t_b)
    right = (a <= -t_a) & (a > -t_b)
    return front, left, right


def _by_quadrant(angle, front, v_front, side, v_side, v_rear,
                 right=None, v_right=None):
    """Per-element constant by impact quadrant, in the angle's dtype (a
    `torch.where` of two Python numbers would come out in float32)."""
    out = torch.full_like(angle, v_rear)
    if right is not None:
        out = torch.where(right, v_right, out)
    out = torch.where(side, v_side, out)
    return torch.where(front, v_front, out)


def _reduced_sym_area_coeff(angle, side, rear):
    """4-area symmetric coefficient."""
    front, left, right = _quadrants(angle)
    return _by_quadrant(angle, front, 0.0, left | right, side, rear)


def _reduced_area_coeff(angle, driver_side, right_side, rear):
    """4-area asymmetric coefficient (`driver_side` is the left side)."""
    front, left, right = _quadrants(angle)
    return _by_quadrant(angle, front, 0.0, left, driver_side, rear,
                        right, right_side)


def _complete_area_coeff(angle, imp11):
    """12-area asymmetric coefficient: impact 12 is frontal (±15°), impacts
    1..11 follow in 30° sectors; angles above +15° are taken 2π lower so that
    impacts 7..11 fall into the same descending scan."""
    a = angle_range(angle)
    a_wrapped = torch.where(a > 15 * _DEG, a - 2 * math.pi, a)
    out = torch.zeros_like(a)
    for i in range(11):  # impacts 1..11
        lo = (-15.0 - 30.0 * (i + 1)) * _DEG
        hi = lo + 30.0 * _DEG
        out = torch.where((a_wrapped > lo) & (a_wrapped <= hi), imp11[i], out)
    return out


def log_reg_harm(delta_v, angle, coeffs=DEFAULT_HARM_COEFFS, *,
                 ignore_angle=False, sym=True, reduced=True):
    """MAIS3+ probability via logistic regression (all 5 variants):
    p = 1 / (1 + exp(-const - speed·Δv - area_coeff(angle)))."""
    lr = coeffs["log_reg"]
    if ignore_angle:
        c = lr["ignore_angle"]
        area = 0.0
    elif sym and reduced:
        c = lr["reduced_sym_angle_areas"]
        area = _reduced_sym_area_coeff(angle, c["side"], c["rear"])
    elif sym:
        c = lr["complete_sym_angle_areas"]
        area = _sym_area_coeff(angle, c["imp"])
    elif reduced:
        c = lr["reduced_angle_areas"]
        area = _reduced_area_coeff(angle, c["driver_side"], c["right_side"], c["rear"])
    else:
        c = lr["complete_angle_areas"]
        area = _complete_area_coeff(angle, c["imp"])
    return 1.0 / (1.0 + torch.exp(-c["const"] - c["speed"] * delta_v - area))


def ref_speed_harm(delta_v, angle, coeffs=DEFAULT_HARM_COEFFS, *,
                   ignore_angle=False, sym=True, reduced=True):
    """MAIS3+ probability via the reference-speed model:
    p = min((Δv / v_ref(angle))^exp, 1)."""
    rs = coeffs["ref_speed"]
    if ignore_angle:
        c = rs["ignore_angle"]
        v_ref = torch.full_like(delta_v, c["ref_speed"])
    elif sym and reduced:
        c = rs["reduced_sym_angle_areas"]
        front, left, right = _quadrants(angle)
        v_ref = _by_quadrant(angle, front, c["front"], left | right, c["side"],
                             c["rear"])
    elif sym:
        c = rs["complete_sym_angle_areas"]
        sp = c["speeds"]
        a = torch.abs(angle_range(angle))
        bins = [a < 15 * _DEG] + [
            (a >= (15 + 30 * i) * _DEG) & (a < (45 + 30 * i) * _DEG) for i in range(5)
        ]
        vals = [torch.full_like(a, sp[6])] + [torch.full_like(a, sp[i])
                                              for i in range(5)]
        v_ref = _select(bins, vals, torch.full_like(a, sp[5]))
    elif reduced:
        c = rs["reduced_angle_areas"]
        front, left, right = _quadrants(angle)
        v_ref = _by_quadrant(angle, front, c["front"], left, c["driver_side"],
                             c["rear"], right, c["right_side"])
    else:
        c = rs["complete_angle_areas"]
        # one fill per speed, not a host list: no host→device copy
        sp = torch.empty(len(c["speeds"]), dtype=delta_v.dtype, device=delta_v.device)
        for i, speed in enumerate(c["speeds"]):
            sp[i:i + 1].fill_(speed)
        idx = torch.clamp(
            torch.floor((angle_range(angle) + math.pi + math.pi / 12)
                        / (math.pi / 6)),
            0, 11,
        ).long()
        v_ref = sp[idx]
    return torch.clamp((delta_v / v_ref) ** c["exp"], max=1.0)


def gidas_harm(delta_v, coeffs=DEFAULT_HARM_COEFFS):
    """MAIS2+ probability."""
    c = coeffs["gidas"]
    return 1.0 / (1.0 + torch.exp(-c["const"] - c["speed"] * delta_v))


def pedestrian_harm(delta_v, coeffs=DEFAULT_HARM_COEFFS):
    """Unprotected road user MAIS3+ (the positive `const` enters with the
    opposite sign)."""
    c = coeffs["pedestrian"]
    return 1.0 / (1.0 + torch.exp(c["const"] - c["speed"] * delta_v))
