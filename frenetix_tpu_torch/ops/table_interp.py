"""K1: linear interpolation of reference-table rows (CUDA kernel + plain twin).

The Hopper port of the Pallas TPU kernel
`frenetix_tpu/ops/pallas_interp.py::_interp_kernel`.  For P queries with a
global row `gidx[p]` and a factor `lam[p]` it evaluates, for every column c of
the (R, C) table,

    out[c, p] = (1 - lam[p]) * table[gidx[p], c] + lam[p] * table[gidx[p] + 1, c]

and returns the column-major (C, P) result that
`geometry.frenet.interp_ref_tables` consumes.

`interp_rows` launches the CUDA kernel (`csrc/table_interp.cu`) for tensors
on a CUDA device and uses the plain PyTorch twin `interp_rows_plain` only for
tensors on the CPU.  A CUDA tensor either reaches the kernel or raises.
Each launch counts 1 on the host counter `kernel.k1.launches`
(`utils.tracing`); calls of the plain twin are not counted.
"""
from __future__ import annotations

import ctypes

import torch

from frenetix_tpu_torch.ops import _kernels
from frenetix_tpu_torch.utils import tracing

__all__ = ["interp_rows", "interp_rows_plain", "launch_empty"]

_KERNEL = "table_interp"
_ENTRY = {torch.float32: "table_interp_f32", torch.float64: "table_interp_f64"}


def interp_rows_plain(table: torch.Tensor, gidx: torch.Tensor,
                      lam: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, same operation order:
    (1 - λ)·lo + λ·hi, each product rounded on its own."""
    rows = gidx.long()
    lo = table[rows].T           # (C, P)
    hi = table[rows + 1].T
    return ((1 - lam) * lo + lam * hi).contiguous()


def _entry(dtype):
    lib = _kernels.load_library(_KERNEL)
    fn = getattr(lib, _ENTRY[dtype])
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ]
    return fn


def launch_empty(device: torch.device) -> None:
    """Launch the library's empty kernel (one thread, no work) on `device`'s
    current stream, through the same ctypes path as `interp_rows`: its device
    time is the floor of one launch.  Not counted."""
    fn = _kernels.load_library(_KERNEL).table_interp_empty
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def interp_rows(table: torch.Tensor, gidx: torch.Tensor,
                lam: torch.Tensor) -> torch.Tensor:
    """(C, P) interpolated table columns at global rows `gidx` (int32, each
    in [0, R-2]) with factors `lam`; `table` is the full (R, C) table.

    For a batch of agents the caller lays their (R, C) tables end to end as
    one (A·R, C) table and adds a·R to agent a's rows
    (`geometry.frenet.interp_ref_tables`): one launch for all agents.  A
    per-agent row is at most R-2, so row+1 stays inside the agent's table."""
    tensors = (table, gidx, lam)
    if all(t.device.type == "cpu" for t in tensors):
        return interp_rows_plain(table, gidx, lam)
    device = table.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "interp_rows: table, gidx and lam must all lie on the CPU or all "
            f"on one CUDA device (got {[str(t.device) for t in tensors]})"
        )
    if table.dtype not in _ENTRY or lam.dtype != table.dtype:
        raise TypeError(
            "interp_rows: table and lam must both be float32 or float64 "
            f"(got {table.dtype}, {lam.dtype})"
        )
    if gidx.dtype != torch.int32:
        raise TypeError(f"interp_rows: gidx must be int32 (got {gidx.dtype})")
    if table.dim() != 2 or table.shape[0] < 2:
        raise ValueError(
            f"interp_rows: table must be (R >= 2, C) (got {tuple(table.shape)})")
    if gidx.dim() != 1 or lam.shape != gidx.shape:
        raise ValueError(
            "interp_rows: gidx and lam must be 1-D of equal length (got "
            f"{tuple(gidx.shape)}, {tuple(lam.shape)})"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("interp_rows: table, gidx and lam must be contiguous")

    n_cols = table.shape[1]
    n_queries = gidx.shape[0]
    out = torch.empty((n_cols, n_queries), dtype=table.dtype, device=device)
    if n_queries == 0 or n_cols == 0:
        return out
    fn = _entry(table.dtype)
    # the C entry launches on the current device; make it the tensors' own
    # for the call only, so the caller's current device is left as it was
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            ctypes.c_void_p(table.data_ptr()), n_cols,
            ctypes.c_void_p(gidx.data_ptr()), ctypes.c_void_p(lam.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n_queries, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"table_interp kernel launch failed: CUDA error {err}")
    tracing.count("kernel.k1.launches", 1)
    return out
