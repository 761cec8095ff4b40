"""Many agents' replanning request in one batched cycle: the host builds
each agent's sampling matrix and stacks them, the compiled
`parallel.mesh.batched_full_cycle` (with the configuration's
responsibility weight, over the request's reach grids) evaluates and
selects, and the selection comes to the host in one copy.

While an Entry with a responsibility weight lives, two of the program's
functions are wrapped (`_Taps`): `parallel.mesh.responsibility_reach_grid`
hands its output on to the per-agent gather `parallel.mesh._select`, which
adds it to the program's outputs.  The window's compiled program then also returns the
responsibility term of every candidate as the post-pass computed it, and
the one copy brings it with the selection: the check holds the risk
stack's term of every candidate to the reference, not only the pick's."""
from __future__ import annotations

import numpy as np
import torch

from frenetix_tpu_torch.parallel import mesh
from frenetix_tpu_torch.parallel.mesh import batched_full_cycle
from frenetix_tpu_torch.planner.core import evaluate_cycle
from frenetix_tpu_torch.risk.harm import meta_from_footprint
from frenetix_tpu_torch.risk.reachable_set import ReachSetGrid

from portbench.entries import common

ROWS = ("x", "y", "theta", "v", "a", "kappa", "s", "s_dot", "s_ddot", "d", "d_dot",
        "d_ddot")
OUTPUTS = ROWS + ("cost", "best", "found", "histogram")
_OWN = (mesh.responsibility_reach_grid, mesh._select)


class _Taps:
    """The wrapped `mesh.responsibility_reach_grid` and `mesh._select`
    (see the module's doc); `remove()` puts the program's own back."""

    def __init__(self):
        self.term = None
        mesh.responsibility_reach_grid, mesh._select = self.responsibility, self.select

    def responsibility(self, *args, **kwargs):
        self.term = _OWN[0](*args, **kwargs)
        return self.term

    def select(self, res, cost=None, best=None, found=None):
        out = _OWN[1](res, cost, best, found)
        out["responsibility"], self.term = self.term, None
        return out

    @staticmethod
    def remove():
        mesh.responsibility_reach_grid, mesh._select = _OWN


class Entry(common.Base):
    def __init__(self, config, lines, device, tracing=False):
        super().__init__(config, lines, device, tracing)
        self.w_resp = float(config.get("responsibility", 0.0))
        self.program = batched_full_cycle(dt=self.dt, n_steps=self.n_steps,
                                          table_window=config["table_window"],
                                          resp_weight=self.w_resp)
        self.outputs = OUTPUTS
        if self.w_resp:
            self.program.clear()        # capture anew, through the taps
            self.taps = _Taps()
            self.outputs = OUTPUTS + ("responsibility",)
        a = config["agents"]
        m = config["sampling"]["bucket"] * -(-config["candidates_per_agent"]
                                             // config["sampling"]["bucket"])
        self.k1_shape = (a * self.ref.s.shape[-1], 7, a * m * (self.n_steps + 1))

    def prepare(self, req):
        floats, bools = common.FLOATS, common.BOOLS
        if self.w_resp:
            floats, bools = floats + common.GRID_FLOATS, bools + common.GRID_BOOLS
        return req, self.packed(req, floats, bools)

    def _inputs(self, prepared):
        req, packed = prepared
        with self.span("portbench.matrix"):
            built = [self.matrix(req, a) for a in range(self.config["agents"])]
            matrices = np.stack([m for m, _ in built])
            masks = np.stack([k for _, k in built])
        with self.span("portbench.upload"):
            t = self.upload(packed)
            matrices_t = torch.from_numpy(matrices).to(self.device)
            masks_t = self.mask(masks)
        extras = ()
        if self.w_resp:
            extras = (ReachSetGrid(origin=t["grid_origin"], occupancy=t["grid_occupancy"],
                                   valid=t["grid_valid"], cell=t["grid_cell"],
                                   dt_rs=float(self.config["reach_grid_dt_s"])),)
        return matrices_t, masks_t, self.context(t, agent_axis=True), extras

    def request(self, prepared):
        matrices, masks, ctx, extras = self._inputs(prepared)
        with self.span("portbench.program"):
            out = self.program(matrices, masks, ctx, *extras)
            a = matrices.shape[0]
            flat = torch.cat([out[k].reshape(a, -1).to(self.dtype) for k in self.outputs],
                             dim=1)
        with self.span("portbench.fetch"):
            return flat.cpu().numpy()

    def answer(self, flat):
        n1 = self.n_steps + 1
        a = flat.shape[0]
        rows = flat[:, :12 * n1].reshape(a, 12, n1).astype(np.float64)
        tail = flat[:, 12 * n1:]
        out = dict(found=tail[:, 2] > 0.5, best=tail[:, 1].astype(np.int64),
                   cost=tail[:, 0].astype(np.float64), rows=rows,
                   hist=tail[:, 3:14].astype(np.int64))
        if self.w_resp:
            out["resp"] = self.w_resp * tail[:, 14:].astype(np.float64)
        return out

    def risk_inputs(self, prepared):
        if not self.w_resp:
            return None
        matrices, masks, ctx, _ = self._inputs(prepared)
        res = evaluate_cycle(matrices, masks, ctx, dt=self.dt, n_steps=self.n_steps,
                             low_vel_mode=False, table_window=self.config["table_window"])
        meta = meta_from_footprint(ctx.preds.lengths, ctx.preds.widths)
        return res.rollout, ctx.preds, meta, self.veh.mass

    def free(self):
        _Taps.remove()
        self.program.clear()
        evaluate_cycle.clear()
        self.masks.clear()
