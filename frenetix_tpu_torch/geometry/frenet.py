"""Batched Frenet ↔ Cartesian conversions against reference-path tables.

PyTorch port of `frenetix_tpu/geometry/frenet.py`.  The table lookup of a
replanning cycle goes through the K1 kernel (`ops.table_interp.interp_rows`):
a gather of rows i and i+1 of the full table and a lerp, column-major out.
The JAX package's bf16-safe matrix forms (`interp_weights`,
`_split_precision_interp`) exist only for the TPU's matrix unit and have no
counterpart here.

`ref` is a `frenetix_tpu_torch.geometry.refpath.RefPathTable` whose fields are
tensors (xy (R, 2), s, theta, kappa, kappa_d, kappa_dd (R,)), uniformly
spaced in s.  The lookups accept leading agent axes on the tables and the
queries alike (see `interp_ref_tables`).
"""
from __future__ import annotations

import torch

from frenetix_tpu_torch.ops.table_interp import interp_rows

__all__ = [
    "segment_index",
    "interp_table",
    "interp_angle_table",
    "interp_ref_tables",
    "interp_columns",
    "wrap_valid_orientation",
    "frenet_to_cartesian",
    "cartesian_to_frenet",
]

TWO_PI = 6.283185307179586


def wrap_valid_orientation(theta):
    """Wrap into (-2π, 2π) by fmod (sign follows the dividend)."""
    return torch.fmod(theta, TWO_PI)


def _lead(v, like):
    """`v` (batch shape B) with trailing singleton axes up to `like`'s rank,
    so a per-agent scalar broadcasts against (B..., M, N+1) queries."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def segment_index(ref_s, s):
    """Segment index i = clip(floor(s/ds), 0, R-2), factor λ = s/ds - i (not
    recomputed after the clip, so out-of-domain queries extrapolate) and the
    in-domain mask ref_s[0] <= s <= ref_s[-1].

    `ref_s` is (R,) or, with leading agent axes, (B..., R); `s` then starts
    with the same B."""
    ds = _lead(ref_s[..., 1] - ref_s[..., 0], s)
    idx = torch.clamp(torch.floor(s / ds).to(torch.int32), 0, ref_s.shape[-1] - 2)
    lam = s / ds - idx.to(s.dtype)
    in_domain = (s >= _lead(ref_s[..., 0], s)) & (s <= _lead(ref_s[..., -1], s))
    return idx, lam, in_domain


def interp_ref_tables(ref, s, extra_tables=None, window_rows=None,
                      window_anchor=None):
    """Interpolated (alpha, theta_lerp, k_r, k_r_d, x, y) at arclengths `s`
    (any batch shape), plus `extras` (a tuple of the K interpolated columns
    of `extra_tables` (R, K), or None), `idx`, `lam` and `in_domain`.

    With `window_rows` W < R the lookup reproduces the JAX window exactly: a
    window of W rows starting at clip(floor(anchor/ds) - W//8, 0, R-W); the
    in-domain mask also requires the query to fall inside the window; the
    local index is clipped to [0, W-2] while λ keeps its unclipped value.
    The kernel reads global rows offset + local index of the full table,
    which gives the values of the JAX window copy.

    With leading agent axes B on the tables (`ref.s` (B..., R), `s`
    (B..., ...), `window_anchor` (B...)) the per-agent tables are laid end
    to end as one (A·R, C) table, A = ∏B, and agent a's rows get a·R added,
    so the whole batch is ONE kernel launch.  A per-agent row index lies in
    [0, R-2], so row+1 never reaches the next agent's table."""
    idx, lam, in_dom = segment_index(ref.s, s)
    cols = [ref.theta, ref.kappa, ref.kappa_d, ref.xy[..., 0], ref.xy[..., 1]]
    tables = torch.stack(cols, dim=-1)                     # (B..., R, C)
    if extra_tables is not None:
        tables = torch.cat([tables, extra_tables.to(tables.dtype)], dim=-1)

    r = ref.s.shape[-1]
    if window_rows is not None and window_rows < r:
        ds = ref.s[..., 1] - ref.s[..., 0]
        margin = window_rows // 8
        offset = _lead(torch.clamp(
            torch.floor(window_anchor / ds).to(torch.int32) - margin,
            0, r - window_rows,
        ), s)
        idx_local = idx - offset
        in_window = (idx_local >= 0) & (idx_local <= window_rows - 2)
        in_dom = in_dom & in_window
        gidx = offset + torch.clamp(idx_local, 0, window_rows - 2)
    else:
        gidx = idx

    field = interp_columns(tables, gidx, lam)
    return {
        "alpha": wrap_valid_orientation(field[0]),
        "theta_lerp": field[0],
        "k_r": field[1],
        "k_r_d": field[2],
        "x": field[3],
        "y": field[4],
        "extras": tuple(field[5:]) if extra_tables is not None else None,
        "idx": idx,
        "lam": lam,
        "in_domain": in_dom,
    }


def interp_columns(tables, rows, lam):
    """The C columns of `tables` (B..., R, C) interpolated at rows `rows`
    (int32, each in [0, R-2], shape (B..., Q...)) with factors `lam`, as a
    list of C tensors shaped like `rows`: ONE K1 launch on the (A·R, C)
    table that lays the A = ∏B agents' tables end to end, agent a's rows
    offset by a·R."""
    r, n_cols = tables.shape[-2], tables.shape[-1]
    lead_shape = tables.shape[:-2]
    gidx = rows
    if lead_shape:
        base = torch.arange(lead_shape.numel(), dtype=torch.int32, device=rows.device) * r
        gidx = gidx + _lead(base.reshape(lead_shape), rows)
    vals_t = interp_rows(tables.reshape(-1, n_cols).contiguous(),
                         gidx.reshape(-1).contiguous(),
                         lam.reshape(-1).contiguous())     # (C, P)
    return [vals_t[i].reshape(rows.shape) for i in range(n_cols)]


def interp_table(table, idx, lam):
    """table[idx] + λ(table[idx+1] - table[idx]); table (R,) or (R, C)."""
    rows = idx.long()
    lo = table[rows]
    hi = table[rows + 1]
    if table.dim() == 2:
        lam = lam[..., None]
    return lo + lam * (hi - lo)


def interp_angle_table(theta_table, idx, lam):
    """Lerp of the unwrapped angle table followed by the fmod wrap."""
    return wrap_valid_orientation(interp_table(theta_table, idx, lam))


def frenet_to_cartesian(ref, s, d):
    """(s, d) → (x, y, in_domain): the path point at s plus d along the left
    normal of the interpolated tangent."""
    t = interp_ref_tables(ref, s)
    theta = t["theta_lerp"]
    x = t["x"] - d * torch.sin(theta)
    y = t["y"] + d * torch.cos(theta)
    return x, y, t["in_domain"]


def cartesian_to_frenet(ref, x, y):
    """(x, y) → (s, d) by closest-point projection onto the polyline;
    d > 0 left of the path.  With leading agent axes B on the tables
    (`ref.xy` (B..., R, 2)) the queries start with the same B, and each
    agent's points project onto its own path."""
    p = torch.stack(torch.broadcast_tensors(torch.as_tensor(x), torch.as_tensor(y)),
                    dim=-1)
    batch_shape = p.shape[:-1]
    xy = ref.xy.reshape((-1,) + tuple(ref.xy.shape[-2:]))    # (A, R, 2)
    ref_s = ref.s.reshape(xy.shape[0], -1)                    # (A, R)
    pf = p.reshape(xy.shape[0], -1, 1, 2)                     # (A, P, 1, 2)
    a = xy[:, None, :-1, :]
    b = xy[:, None, 1:, :]
    ab = b - a
    ap = pf - a
    seg_len2 = torch.sum(ab * ab, dim=-1)
    t = torch.clamp(torch.sum(ap * ab, dim=-1) / torch.clamp(seg_len2, min=1e-12),
                    0.0, 1.0)
    closest = a + t[..., None] * ab
    diff = pf - closest
    dist2 = torch.sum(diff * diff, dim=-1)          # (A, P, R-1)
    best = torch.argmin(dist2, dim=-1)              # (A, P)

    def pick(v):
        return torch.gather(v, -1, best[..., None])[..., 0]

    t_best = pick(t)
    s_lo = torch.gather(ref_s, 1, best)
    seg_s = s_lo + t_best * (torch.gather(ref_s, 1, best + 1) - s_lo)
    ab_best = torch.gather(ab[:, 0], 1, best[..., None].expand(-1, -1, 2))
    ap_best = pf[:, :, 0, :] - torch.gather(a[:, 0], 1, best[..., None].expand(-1, -1, 2))
    cross = ab_best[..., 0] * ap_best[..., 1] - ab_best[..., 1] * ap_best[..., 0]
    dist = torch.sqrt(pick(dist2))
    d = torch.where(cross >= 0.0, dist, -dist)
    return seg_s.reshape(batch_shape), d.reshape(batch_shape)
