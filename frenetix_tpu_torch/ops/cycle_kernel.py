"""K3: the cycle's stages after the rollout on the card, one CUDA kernel.

`planner.core.cycle_stages` sends CUDA tensors here.  One launch on the
current stream (`csrc/cycle.cu`) reads K2's `Rollout`, the context's
predictions, obstacles, lane segments and weights, and `valid_mask`, and
writes per candidate row:

- the 13 columns of `cost_terms` in `ops.costs.COST_TERM_ORDER`
  (responsibility the zero column) and `cost`, their weighted total;
- `collides`, the prediction collisions (`ops.collision.prediction_collisions`);
- `boundary_step` and `boundary_harm`, the first step off the corridor
  and the harm at its velocity (-1 and 0 without the boundary check);
- `selectable`: feasible, valid, no collision, on the road, in the mask.

The plain twin is `planner.core.cycle_stages_plain` (the stage functions
of `ops.costs` and `ops.collision`), the CPU path.  On the card K3's
flags, steps, harms and closed-form jerk terms equal the twin's bitwise;
its sums over steps and slots run in one fixed order of their own and
differ from `torch.sum`'s by rounding only.  K3 takes float32 and float64,
any leading agent axes (context leaves per agent or shared), any number of
slots, segments and steps and any prediction horizon; anything else raises
before a launch.  Each call counts one launch on the host counter
`kernel.k3.launches` (`utils.tracing`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from frenetix_tpu_torch.ops import _kernels
from frenetix_tpu_torch.utils import tracing

__all__ = ["cycle_fields"]

_KERNEL = "cycle"
_ENTRY = {torch.float32: "cycle_k3_f32", torch.float64: "cycle_k3_f64"}
N_TERMS = 13
# shared memory of a block, in elements: the staged window (9 arrays of
# slots x 32 steps), the slots' half-sizes, the current obstacles, the
# lane segments (csrc/cycle.cu::shared_elements)
_WINDOW, _PER_SLOT, _PER_OBSTACLE, _PER_SEGMENT = 9 * 32, 2, 3, 6
MAX_SHARED_BYTES = 232_448

_PTR, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double

_ROLLOUT = ("x", "y", "theta_gl", "theta_cl", "v", "a", "d")
# (pointer, its strides): an agent stride first, then the trailing axes'
_STRIDED = (
    ("mask", ("mask_sa", "mask_sm")),
    ("means", ("mu_sa", "mu_so", "mu_st", "mu_sc")),
    ("inv_covs", ("ic_sa", "ic_so", "ic_st", "ic_si", "ic_sj")),
    ("orientations", ("or_sa", "or_so", "or_st")),
    ("pred_valid", ("pv_sa", "pv_so", "pv_st")),
    ("lengths", ("ln_sa", "ln_so")),
    ("widths", ("wd_sa", "wd_so")),
    ("obstacle_xy", ("ox_sa", "ox_so", "ox_sc")),
    ("obstacle_valid", ("ov_sa", "ov_so")),
    ("lane_segments", ("ls_sa", "ls_ss", "ls_sp", "ls_sc")),
    ("lane_valid", ("lv_sa", "lv_ss")),
    ("v_des", ("vd_sa",)),
    ("v_avg", ("va_sa",)),
    ("weights", ("w_sa", "w_sk")),
)
_OUTPUTS = ("cost_terms", "cost", "collides", "boundary_step", "boundary_harm",
            "selectable")


class _Args(ctypes.Structure):
    """`Args` of `csrc/cycle.cu`, field for field."""

    _fields_ = (
        [(name, _PTR) for name in _ROLLOUT + ("d_lo", "d_hi", "coeffs_lon", "coeffs_lat",
                                             "feasible", "valid")]
        + [field for ptr, strides in _STRIDED
           for field in [(ptr, _PTR)] + [(s, _I64) for s in strides]]
        + [(name, _I64) for name in ("n_agents", "n_rows", "n1", "n_slots", "horizon",
                                     "n_obstacles", "n_segments")]
        + [(name, _F64) for name in ("dt", "dt2", "dt3", "dt4", "dt5", "dt_third",
                                     "half_dt", "wb_rear_axle", "half_length",
                                     "half_width", "harm_const", "harm_speed")]
        + [(name, _PTR) for name in _OUTPUTS]
    )


def _entry(dtype):
    fn = getattr(_kernels.load_library(_KERNEL), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, _PTR]
    return fn


def _check(ro, valid_mask, ctx, check_boundary):
    """Raise on what K3 does not take: tensors off the rollout's CUDA device,
    a dtype other than float32 / float64 or other than the rollout's, masks
    that are not bool, no corridor columns for the boundary check."""
    preds = ctx.preds
    floats = [getattr(ro, f) for f in _ROLLOUT] + [
        ro.coeffs_lon, ro.coeffs_lat, preds.means, preds.inv_covs, preds.orientations,
        preds.lengths, preds.widths, ctx.obstacle_xy, ctx.lane_segments, ctx.weights]
    masks = [ro.feasible, ro.valid, valid_mask, preds.valid, ctx.obstacle_valid,
             ctx.lane_valid]
    extras = list(ro.extras[:2]) if check_boundary and ro.extras is not None else []
    scalars = [t for t in (ctx.desired_velocity, ctx.desired_avg_velocity)
               if isinstance(t, torch.Tensor)]
    device, dtype = ro.x.device, ro.x.dtype
    tensors = floats + masks + extras + scalars
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "cycle_stages: on the card the rollout, the mask and the context's "
            "predictions, obstacles, lane segments and weights must lie on one CUDA "
            f"device (got {sorted({str(t.device) for t in tensors})})")
    if dtype not in _ENTRY or any(t.dtype != dtype for t in floats + extras):
        raise TypeError(
            "cycle_stages: K3 takes a float32 or float64 rollout and context of its "
            f"dtype (got {sorted({str(t.dtype) for t in floats + extras})})")
    if any(t.dtype != torch.bool for t in masks):
        raise TypeError("cycle_stages: the masks must be bool (got "
                        f"{sorted({str(t.dtype) for t in masks})})")
    if check_boundary and len(extras) < 2:
        raise ValueError("cycle_stages: the boundary check needs the rollout's two "
                         "corridor columns (ro.extras)")


def _per_agent(t, lead, trailing, what):
    """`t` (lead..., *trailing) or (*trailing) as (A, *trailing), A = ∏lead: a
    view (agent stride 0 where `t` is shared) wherever the strides allow."""
    n = t.dim() - len(trailing)
    if n < 0 or tuple(t.shape[n:]) != tuple(trailing):
        raise ValueError(f"cycle_stages: {what} must end in {tuple(trailing)} (got "
                         f"{tuple(t.shape)})")
    try:
        t = t.expand(lead + tuple(trailing))
    except RuntimeError as err:
        raise ValueError(f"cycle_stages: {what}'s leading axes {tuple(t.shape[:n])} do "
                         f"not broadcast to the rollout's {lead}") from err
    return t.reshape((math.prod(lead),) + tuple(trailing))


def _arguments(ro, valid_mask, ctx, *, dt, check_boundary, harm_coeffs):
    """The kernel's argument block, its outputs, and the tensors it points
    into (kept alive until the launch is queued)."""
    lead, (m_rows, n1) = tuple(ro.x.shape[:-2]), tuple(ro.x.shape[-2:])
    n_agents = math.prod(lead)
    device, dtype = ro.x.device, ro.x.dtype
    preds = ctx.preds
    n_slots, horizon = preds.means.shape[-3], preds.means.shape[-2]
    n_obstacles, n_segments = ctx.obstacle_xy.shape[-2], ctx.lane_segments.shape[-3]
    if n_slots and horizon < 1:
        raise ValueError("cycle_stages: predictions of O > 0 slots need T >= 1 steps")
    shared = ro.x.element_size() * (_WINDOW * n_slots + _PER_SLOT * n_slots
                                    + _PER_OBSTACLE * n_obstacles
                                    + _PER_SEGMENT * n_segments)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"cycle_stages: {n_slots} slots, {n_obstacles} obstacles and {n_segments} "
            f"lane segments need {shared} B of shared memory a block, more than the "
            f"card's {MAX_SHARED_BYTES}")

    def rows(t, cols=n1):
        return t.reshape(n_agents * m_rows, cols).contiguous()

    def scalar(value):
        return torch.as_tensor(value, dtype=dtype, device=device)

    views = {name: rows(getattr(ro, name)) for name in _ROLLOUT}
    views.update(coeffs_lon=rows(ro.coeffs_lon, 6), coeffs_lat=rows(ro.coeffs_lat, 6),
                 feasible=ro.feasible.reshape(-1).contiguous(),
                 valid=ro.valid.reshape(-1).contiguous())
    if check_boundary:
        views.update(d_lo=rows(ro.extras[0]), d_hi=rows(ro.extras[1]))
    t_o = (n_slots, horizon)
    strided = {
        "mask": _per_agent(valid_mask, lead, (m_rows,), "valid_mask"),
        "means": _per_agent(preds.means, lead, t_o + (2,), "preds.means"),
        "inv_covs": _per_agent(preds.inv_covs, lead, t_o + (2, 2), "preds.inv_covs"),
        "orientations": _per_agent(preds.orientations, lead, t_o, "preds.orientations"),
        "pred_valid": _per_agent(preds.valid, lead, t_o, "preds.valid"),
        "lengths": _per_agent(preds.lengths, lead, (n_slots,), "preds.lengths"),
        "widths": _per_agent(preds.widths, lead, (n_slots,), "preds.widths"),
        "obstacle_xy": _per_agent(ctx.obstacle_xy, lead, (n_obstacles, 2), "obstacle_xy"),
        "obstacle_valid": _per_agent(ctx.obstacle_valid, lead, (n_obstacles,),
                                     "obstacle_valid"),
        "lane_segments": _per_agent(ctx.lane_segments, lead, (n_segments, 2, 2),
                                    "lane_segments"),
        "lane_valid": _per_agent(ctx.lane_valid, lead, (n_segments,), "lane_valid"),
        "v_des": _per_agent(scalar(ctx.desired_velocity), lead, (), "desired_velocity"),
        "v_avg": _per_agent(scalar(ctx.desired_avg_velocity), lead, (),
                            "desired_avg_velocity"),
        "weights": _per_agent(ctx.weights, lead, (N_TERMS,), "weights"),
    }
    shape = lead + (m_rows,)
    out = {
        "cost_terms": torch.empty(shape + (N_TERMS,), dtype=dtype, device=device),
        "cost": torch.empty(shape, dtype=dtype, device=device),
        "collides": torch.empty(shape, dtype=torch.bool, device=device),
        "boundary_step": torch.empty(shape, dtype=torch.int32, device=device),
        "boundary_harm": torch.empty(shape, dtype=dtype, device=device),
        "selectable": torch.empty(shape, dtype=torch.bool, device=device),
    }

    args = _Args()
    for name, t in views.items():
        setattr(args, name, t.data_ptr())
    for ptr, strides in _STRIDED:
        t = strided[ptr]
        setattr(args, ptr, t.data_ptr())
        for name, stride in zip(strides, t.stride()):
            setattr(args, name, stride)
    for name, t in out.items():
        setattr(args, name, t.data_ptr())
    args.n_agents, args.n_rows, args.n1 = n_agents, m_rows, n1
    args.n_slots, args.horizon = n_slots, horizon
    args.n_obstacles, args.n_segments = n_obstacles, n_segments
    # dt and its powers as ops.polynomials.squared_jerk_integral computes them
    args.dt = dt
    args.dt2 = dt * dt
    args.dt3 = args.dt2 * dt
    args.dt4 = args.dt3 * dt
    args.dt5 = args.dt4 * dt
    args.dt_third, args.half_dt = dt / 3.0, 0.5 * dt
    veh = ctx.veh
    args.wb_rear_axle = veh.wb_rear_axle
    args.half_length, args.half_width = veh.length / 2.0, veh.width / 2.0
    args.harm_const, args.harm_speed = harm_coeffs
    return args, out, (views, strided)


def cycle_fields(ro, valid_mask, ctx, *, dt, check_boundary, compensated_sum,
                 harm_coeffs) -> dict:
    """`cost_terms`, `cost`, `collides`, `boundary_step`, `boundary_harm` and
    `selectable` of a rollout on the card, by K3 (arguments as
    `planner.core.cycle_stages`)."""
    _check(ro, valid_mask, ctx, check_boundary)
    args, out, _alive = _arguments(ro, valid_mask, ctx, dt=dt,
                                   check_boundary=check_boundary, harm_coeffs=harm_coeffs)
    k3 = _entry(ro.x.dtype)
    device = ro.x.device
    with torch.cuda.device(device):
        stream = _PTR(torch.cuda.current_stream(device).cuda_stream)
        err = k3(ctypes.byref(args), int(bool(check_boundary)), int(bool(compensated_sum)),
                 stream)
    if err != 0:
        raise RuntimeError(f"cycle kernel K3 launch failed: CUDA error {err}")
    tracing.count("kernel.k3.launches", 1)
    return out
