"""Reference paths: host preprocessing into tables, Frenet ↔ Cartesian
conversions against them on the device."""

from frenetix_tpu_torch.geometry.refpath import RefPathTable, prepare_reference_path  # noqa: F401
