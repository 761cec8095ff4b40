"""Frenet ↔ Cartesian conversions against device-resident reference tables."""
