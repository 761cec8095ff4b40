"""CommonRoad vehicle-model parameter sets (cr_vehicle_id 1/2/3).

The port's own copy of `frenetix_tpu/ops/vehicle_db.py` over the port's
`ops/kinematics.py::VehicleParams`.  It carries the published constants of
the three passenger-car models of the commonroad-vehicle-models package
(parameters_vehicle{1,2,3}.py):

  1 — Ford Escort, 2 — BMW 320i, 3 — VW Vanagon.

`resolve_vehicle` keeps the configuration semantics of the JAX package: the
database values first, then every explicitly given (non-None) override wins.

The default `VehicleParams` (no id) predate this database and differ from
its BMW 320i in mass (1475 vs 1093.3 kg) and delta_max (1.023 vs 1.066 rad);
`cr_vehicle_id: null` (the default) keeps them, any explicit id resolves
from the database.
"""
from __future__ import annotations

from frenetix_tpu_torch.ops.kinematics import VehicleParams

__all__ = ["VEHICLE_DB", "resolve_vehicle"]

# published model constants; wheelbase = a + b (distances CoG→front/rear
# axle), wb_rear_axle = b
VEHICLE_DB = {
    1: {  # Ford Escort (parameters_vehicle1.py)
        "length": 4.298, "width": 1.674, "mass": 1225.887,
        "wb_front_axle": 0.883, "wb_rear_axle": 1.508,
        "a_max": 11.5, "v_max": 45.8, "v_switch": 4.755,
        "delta_max": 0.910, "v_delta_max": 0.4,
    },
    2: {  # BMW 320i (parameters_vehicle2.py)
        "length": 4.508, "width": 1.610, "mass": 1093.295,
        "wb_front_axle": 1.156, "wb_rear_axle": 1.422,
        "a_max": 11.5, "v_max": 50.8, "v_switch": 7.319,
        "delta_max": 1.066, "v_delta_max": 0.4,
    },
    3: {  # VW Vanagon (parameters_vehicle3.py)
        "length": 4.569, "width": 1.844, "mass": 1478.0,
        "wb_front_axle": 1.419, "wb_rear_axle": 1.634,
        "a_max": 11.5, "v_max": 41.7, "v_switch": 4.812,
        "delta_max": 1.023, "v_delta_max": 0.4,
    },
}


def resolve_vehicle(cr_vehicle_id: int, overrides: dict | None = None
                    ) -> VehicleParams:
    """Database lookup + per-field override: every explicitly given non-None
    override replaces the database value; wheelbase defaults to a + b unless
    overridden itself."""
    try:
        db = dict(VEHICLE_DB[int(cr_vehicle_id)])
    except KeyError:
        raise ValueError(
            f"unknown cr_vehicle_id {cr_vehicle_id!r} (known: 1, 2, 3)"
        ) from None
    overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
    wb_front = overrides.pop("wb_front_axle", db.pop("wb_front_axle"))
    fields = {**db, **{k: v for k, v in overrides.items()
                       if k in VehicleParams._fields}}
    unknown = set(overrides) - set(VehicleParams._fields) - {"wheelbase"}
    if unknown:
        raise ValueError(f"unknown vehicle override(s): {sorted(unknown)}")
    fields.setdefault("wheelbase", wb_front + fields["wb_rear_axle"])
    return VehicleParams(**fields)
