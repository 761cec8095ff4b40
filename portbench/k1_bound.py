"""Kernel K1's least time on the card, from its shapes alone.

Frozen copy (commit eab69ff) of `chip_smoke.py::k1_bound_ms` and its two
peaks: one NVIDIA H100 SXM's 3.35 TB/s of HBM and 67 TFLOP/s in float32
outside the tensor cores (NVIDIA's data sheet, at the 700 W power limit).
K1 interpolates P queries over an (R, C) table: it reads the table, one
row index and one factor per query once, and writes the (C, P) result once;
it does one subtraction per query and two products and a sum per output.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def k1_bound_ms(rows: int, cols: int, p: int, itemsize: int = 4):
    """(ms, "bytes" or "operations", bytes) of one K1 call."""
    n_bytes = rows * cols * itemsize + p * (4 + itemsize) + cols * p * itemsize
    n_ops = p + 3 * cols * p
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", n_bytes
