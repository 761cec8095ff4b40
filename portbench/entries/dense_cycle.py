"""One ego vehicle's replanning request on the dense grid: the host builds
the sampling matrix, the compiled `planner.core.evaluate_cycle` evaluates
and selects, and the planner's pack (`planner.reactive._replan_pack`)
brings the selection to the host in one copy."""
from __future__ import annotations

import numpy as np
import torch

from frenetix_tpu_torch.planner import reactive
from frenetix_tpu_torch.planner.core import evaluate_cycle

from portbench.entries import common


class Entry(common.Base):
    def __init__(self, config, lines, device, tracing=False):
        super().__init__(config, lines, device, tracing)
        if config["agents"] != 1 or config.get("responsibility", 0.0):
            raise ValueError("dense_cycle plans one agent without a post-pass")
        m = config["sampling"]["bucket"] * -(-config["candidates_per_agent"]
                                             // config["sampling"]["bucket"])
        r, c = self.ref.s.shape[-1], 7
        self.k1_shape = (r, c, m * (self.n_steps + 1))

    def prepare(self, req):
        return req, self.packed(req, common.FLOATS, common.BOOLS)

    def request(self, prepared):
        req, packed = prepared
        with self.span("portbench.matrix"):
            matrix, mask = self.matrix(req, 0)
        with self.span("portbench.upload"):
            t = self.upload(packed)
            matrix_t = torch.from_numpy(matrix).to(self.device)
            mask_t = self.mask(mask)
        with self.span("portbench.program"):
            ctx = self.context(t, agent_axis=False)
            res = evaluate_cycle(matrix_t, mask_t, ctx, dt=self.dt, n_steps=self.n_steps,
                                 low_vel_mode=False, table_window=self.config["table_window"])
            pack = reactive._replan_pack(res, mask_t)
        with self.span("portbench.fetch"):
            return pack.cpu().numpy()

    def answer(self, pack):
        n1 = self.n_steps + 1
        return dict(found=np.array([pack[0, 0] > 0.5]), best=np.array([int(pack[0, 1])]),
                    cost=np.array([pack[13, 0]], np.float64),
                    rows=pack[None, 1:13, :n1].astype(np.float64),
                    hist=pack[None, 0, 5:16].astype(np.int64))

    def risk_inputs(self, prepared):
        return None

    def free(self):
        evaluate_cycle.clear()
        reactive._replan_pack.clear()
        self.masks.clear()
