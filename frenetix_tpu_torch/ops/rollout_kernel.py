"""K2: the candidate rollout on the card, two CUDA kernels around K1.

`ops.kinematics.rollout_candidates` sends CUDA tensors here.  Three
launches on the current stream compute every field of the `Rollout`
(`csrc/rollout.cu`):

- K2a: the coefficients, traj_len and the Frenet state per step (s, ṡ, s̈,
  d, ḋ, d̈), and for the table lookup K1's global rows and factors; its last
  blocks lay the agents' reference tables (and the corridor columns) end to
  end as K1's (A·R, 5 + K) table;
- K1 (`ops.table_interp.interp_rows`, unchanged);
- K2b: the Cartesian state, the constraint checks and the eleven
  infeasibility slots per candidate.

The plain twin is `ops.kinematics.rollout_candidates_plain`, the CPU path;
K2 equals it bitwise on the card.  The kernels take float32 and float64,
any leading agent axes, one table per agent or one shared by all, any
number K of extra table columns, any n_steps and both modes; anything else
raises before a launch.  Each call counts one launch pair (K2a + K2b) on
the host counter `kernel.k2.launches` (`utils.tracing`), and K1 its own.
"""
from __future__ import annotations

import ctypes
import math

import torch

from frenetix_tpu_torch.ops import _kernels, table_interp
from frenetix_tpu_torch.utils import tracing

__all__ = ["rollout_fields"]

_KERNEL = "rollout"
_ENTRY = {torch.float32: ("rollout_k2a_f32", "rollout_k2b_f32"),
          torch.float64: ("rollout_k2a_f64", "rollout_k2b_f64")}

_PTR, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double


class _Args(ctypes.Structure):
    """`Args` of `csrc/rollout.cu`, field for field."""

    _fields_ = (
        [("matrix", _PTR),
         ("ref_s", _PTR), ("s_sa", _I64), ("s_sr", _I64),
         ("theta", _PTR), ("th_sa", _I64), ("th_sr", _I64),
         ("kappa", _PTR), ("k_sa", _I64), ("k_sr", _I64),
         ("kappa_d", _PTR), ("kd_sa", _I64), ("kd_sr", _I64),
         ("xy", _PTR), ("xy_sa", _I64), ("xy_sr", _I64), ("xy_sc", _I64),
         ("extras", _PTR), ("ex_sa", _I64), ("ex_sr", _I64), ("ex_sc", _I64),
         ("x0", _PTR), ("x0_sa", _I64)]
        + [(name, _I64) for name in ("n_agents", "n_rows", "n1", "table_rows",
                                     "table_agents", "n_extra", "window")]
        + [(name, _F64) for name in ("dt", "a_max", "kappa_max", "kappa_dot_max",
                                     "v_switch", "a_max_v_switch")]
        + [(name, _PTR) for name in ("s", "s_vel", "s_acc", "d", "d_vel", "d_acc",
                                     "coeffs_lon", "coeffs_lat", "traj_len", "gidx",
                                     "lam", "table", "field", "theta_gl", "theta_cl",
                                     "v", "a", "kappa_gl", "kappa_dot", "x", "y",
                                     "feasible", "valid", "slots")]
    )


def _entries(dtype):
    lib = _kernels.load_library(_KERNEL)
    fns = tuple(getattr(lib, name) for name in _ENTRY[dtype])
    for fn in fns:
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, _PTR]
    return fns


def _per_agent(t, lead, trailing):
    """`t` (lead..., *trailing) as a view (A_t, *trailing) with A_t = ∏lead,
    reshaped without a copy where the strides allow it."""
    return t.reshape((math.prod(lead),) + tuple(trailing))


def _check(matrix, ref, extra, x0):
    """Raise on what K2 does not take: tensors off the matrix's CUDA device,
    a dtype other than float32 / float64 or other than the matrix's, a
    matrix without 13 columns, tables whose leading axes are neither the
    matrix's nor empty."""
    device, dtype = matrix.device, matrix.dtype
    tensors = [matrix, *ref[:5]] + ([extra] if extra is not None else []) + (
        [x0] if isinstance(x0, torch.Tensor) else [])
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "rollout_candidates: on the card the matrix, the reference tables, the "
            "extra tables and x0_orientation must lie on one CUDA device (got "
            f"{sorted({str(t.device) for t in tensors})})")
    if dtype not in _ENTRY or any(t.dtype != dtype for t in ref[:5]):
        raise TypeError(
            "rollout_candidates: K2 takes a float32 or float64 matrix and reference "
            f"tables of its dtype (got {dtype}, tables "
            f"{sorted({str(t.dtype) for t in ref[:5]})})")
    if matrix.dim() < 2 or matrix.shape[-1] != 13:
        raise ValueError("rollout_candidates: the matrix must be (B..., M, 13) (got "
                         f"{tuple(matrix.shape)})")
    lead, tlead = tuple(matrix.shape[:-2]), tuple(ref.s.shape[:-1])
    if tlead not in ((), lead):
        raise ValueError(f"rollout_candidates: the tables' leading axes {tlead} are "
                         f"neither the matrix's {lead} nor ()")
    r_rows = ref.s.shape[-1]
    shapes = [(t, tlead + (r_rows,)) for t in ref[1:5]] + [(ref.xy, tlead + (r_rows, 2))]
    if extra is not None:
        shapes.append((extra, tlead + (r_rows, extra.shape[-1])))
    if r_rows < 2 or any(tuple(t.shape) != want for t, want in shapes):
        raise ValueError(
            "rollout_candidates: the tables must be (B..., R >= 2) and xy (B..., R, 2), "
            f"the extra tables (B..., R, K) (got s {tuple(ref.s.shape)}, "
            f"{[tuple(t.shape) for t, _ in shapes]})")


def rollout_fields(matrix, ref, params, *, dt, n_steps, low_vel_mode, x0_orientation,
                   quintic_lon, extra_ref_tables, table_window) -> dict:
    """The `ops.kinematics.Rollout` fields of a (B..., M, 13) matrix on the
    card, by K2a → K1 → K2b (arguments as `rollout_candidates`)."""
    _check(matrix, ref, extra_ref_tables, x0_orientation)
    device, dtype = matrix.device, matrix.dtype
    lead, m_rows = tuple(matrix.shape[:-2]), matrix.shape[-2]
    n_agents = math.prod(lead)
    n1 = n_steps + 1
    r_rows = ref.s.shape[-1]
    tlead = tuple(ref.s.shape[:-1])
    n_extra = 0 if extra_ref_tables is None else extra_ref_tables.shape[-1]
    matrix = matrix.contiguous()

    def empty(*shape, kind=dtype):
        return torch.empty(lead + (m_rows,) + shape, dtype=kind, device=device)

    out = {name: empty(n1) for name in (
        "s", "s_vel", "s_acc", "d", "d_vel", "d_acc", "x", "y", "theta_gl", "theta_cl",
        "v", "a", "kappa_gl", "kappa_dot")}
    out.update(coeffs_lon=empty(6), coeffs_lat=empty(6),
               traj_len=empty(kind=torch.int32), feasible=empty(kind=torch.bool),
               valid=empty(kind=torch.bool), inf_slots=empty(11, kind=torch.bool))
    n_query = n_agents * m_rows * n1
    gidx = torch.empty(n_query, dtype=torch.int32, device=device)
    lam = torch.empty(n_query, dtype=dtype, device=device)
    table = torch.empty((math.prod(tlead) * r_rows, 5 + n_extra), dtype=dtype,
                        device=device)

    s_t, th, ka, kd = (_per_agent(t, tlead, (r_rows,))
                       for t in (ref.s, ref.theta, ref.kappa, ref.kappa_d))
    xy = _per_agent(ref.xy, tlead, (r_rows, 2))
    args = _Args(
        matrix.data_ptr(), s_t.data_ptr(), *s_t.stride(), th.data_ptr(), *th.stride(),
        ka.data_ptr(), *ka.stride(), kd.data_ptr(), *kd.stride(),
        xy.data_ptr(), *xy.stride())
    if n_extra:
        ex = _per_agent(extra_ref_tables.to(dtype), tlead, (r_rows, n_extra))
        args.extras = ex.data_ptr()
        args.ex_sa, args.ex_sr, args.ex_sc = ex.stride()
    if not low_vel_mode:
        x0 = torch.as_tensor(x0_orientation, dtype=dtype, device=device)
        x0 = x0.reshape(1) if x0.numel() == 1 else x0.expand(lead).reshape(n_agents)
        args.x0 = x0.data_ptr()
        args.x0_sa = x0.stride(0) if x0.numel() > 1 else 0
    args.n_agents, args.n_rows, args.n1 = n_agents, m_rows, n1
    args.table_rows, args.table_agents, args.n_extra = r_rows, math.prod(tlead), n_extra
    args.window = table_window if 0 < table_window < r_rows else 0
    args.dt, args.a_max = dt, params.a_max
    args.kappa_max = math.tan(params.delta_max) / params.wheelbase
    args.kappa_dot_max, args.v_switch = params.kappa_dot_max, params.v_switch
    args.a_max_v_switch = params.a_max * params.v_switch
    for name, t in out.items():
        setattr(args, "slots" if name == "inf_slots" else name, t.data_ptr())
    args.gidx, args.lam, args.table = gidx.data_ptr(), lam.data_ptr(), table.data_ptr()

    k2a, k2b = _entries(dtype)
    flags = (int(bool(low_vel_mode)), int(bool(quintic_lon)))
    with torch.cuda.device(device):
        stream = _PTR(torch.cuda.current_stream(device).cuda_stream)
        err = k2a(ctypes.byref(args), *flags, stream)
        if err != 0:
            raise RuntimeError(f"rollout kernel K2a launch failed: CUDA error {err}")
        field = table_interp.interp_rows(table, gidx, lam)      # (5 + K, P)
        args.field = field.data_ptr()
        err = k2b(ctypes.byref(args), *flags, stream)
        if err != 0:
            raise RuntimeError(f"rollout kernel K2b launch failed: CUDA error {err}")
    tracing.count("kernel.k2.launches", 1)
    rows = lead + (m_rows, n1)
    out["extras"] = (tuple(field[5 + k].reshape(rows) for k in range(n_extra))
                     if extra_ref_tables is not None else None)
    return out
