"""Batched multi-agent stepping: all agents' cycles in ONE device pass.

PyTorch port of `frenetix_tpu/parallel/batched_sim.py`.  The host-loop
Simulation steps agents one after the other (one cycle each); this module
evaluates every running agent's replanning cycle in a single pass of
`parallel.mesh.batched_full_cycle`, with the agents as the leading axis and
one K1 launch for all of them.

Both paths run the complete cycle (`planner.core.evaluate_cycle`: boundary
and corridor checking, lane-center costs, the full cost stack), and every op
reduces over trailing axes only, so a batched selection equals the
sequential one on the same inputs.

With a responsibility weight the reach-set term runs in the batch (stacked
reach grids), with the occlusion module the safety gate and the soft costs
do (phantom masks, stacked occluder geometry); see
`parallel.mesh.batched_full_cycle`.

On one device the step is ONE compiled program (the cycle and the next
poses, a CUDA graph per signature: `parallel.mesh._stepper_program`), as
the JAX package jits the two together.

With a `mesh` (`parallel.mesh.make_agent_mesh`) the agent axis is split
over the ranks of a torch.distributed world: every rank evaluates its rows
and all-gathers the selection (`parallel.mesh.sharded_full_cycle`), so each
rank's `step` returns the same full result.
"""
from __future__ import annotations

import numpy as np
import torch

from frenetix_tpu_torch.geometry.refpath import RefPathTable
from frenetix_tpu_torch.occlusion import PhantomThresholds
from frenetix_tpu_torch.parallel.mesh import (
    _pad_table, _stepper_program, sharded_full_cycle,
)
from frenetix_tpu_torch.planner.core import CycleContext

__all__ = ["BatchedAgentStepper"]


class BatchedAgentStepper:
    """Evaluates a batch of per-agent (matrix, context) cycles in one call.

    Agents must share the static configuration (dt, N, bucket); their
    reference paths and corridors are stacked to a common R on the agents'
    device.  Low-velocity and stopping-mode agents are handled by the host
    path (their cycles use other static flags).  With a `mesh` the agents
    are split over its ranks; their number must divide over it."""

    def __init__(self, config, agents, device: torch.device, mesh=None):
        self.config = config
        self.dt = config.planning.dt
        self.n_steps = config.planning.n_steps
        self.agents = agents
        self.device = torch.device(device)
        self.np_dtype = np.float64 if config.dtype == "float64" else np.float32
        self.dtype = torch.float64 if config.dtype == "float64" else torch.float32

        refs = [a.planner.ref_np for a in agents]
        r_max = max(r.s.shape[0] for r in refs)
        self.ref = RefPathTable(**{
            name: self._tensor(np.stack([
                _pad_table(getattr(r, name), r_max, is_pathlength=(name == "s"))
                for r in refs]))
            for name in RefPathTable._fields
        })
        self.corridors = self._tensor(np.stack([
            _pad_table(a.planner.corridor, r_max) for a in agents]))

        # lane segments (for the lane_center_offset cost), padded to common S
        seg_arrays = [a.planner.lane_segments.cpu().numpy() for a in agents]
        s_max = max(s.shape[0] for s in seg_arrays)
        segs = np.zeros((len(agents), s_max, 2, 2), self.np_dtype)
        valids = np.zeros((len(agents), s_max), bool)
        for i, (a, s) in enumerate(zip(agents, seg_arrays)):
            segs[i, :s.shape[0]] = s
            valids[i, :s.shape[0]] = a.planner.lane_valid.cpu().numpy()
        self.lane_segments = self._tensor(segs)
        self.lane_valid = torch.as_tensor(valids, device=self.device)

        # the responsibility term, the occlusion gate and the soft costs
        # run in the batch when they are weighted / enabled
        self.resp_weight = float(config.cost_weights.get("responsibility", 0.0))
        self.use_occlusion = bool(config.occlusion.use_occlusion_module)
        ew = config.external_cost_weights
        w_um, w_ve = float(ew.get("occ_um", 0.0)), float(ew.get("occ_ve", 0.0))
        self.use_occ_geom = self.use_occlusion and (w_um != 0.0 or w_ve != 0.0)
        kwargs = dict(
            dt=self.dt, n_steps=self.n_steps, low_vel_mode=False,
            resp_weight=self.resp_weight, occlusion=self.use_occlusion,
            thresholds=PhantomThresholds.from_config(config.occlusion),
            occ_pm_weight=float(ew.get("occ_pm", 0.0)),
            occ_um_weight=w_um, occ_ve_weight=w_ve,
            compensated_sum=bool(config.planning.compensated_cost_sum),
        )
        if mesh is not None:
            # (out, poses_all), both gathered over the mesh
            self._cycle = sharded_full_cycle(mesh, **kwargs)
        else:
            # the cycle and the next poses, one compiled program
            self._cycle = _stepper_program(**kwargs)

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                               device=self.device)

    def step(self, matrices, masks, preds_stacked, x0_orients, v_desireds,
             veh, weights, reach_grids=None, phantom_masks=None, occ_geom=None):
        """matrices (A, M, 13), masks (A, M), agent-stacked predictions
        (A, O, T, ...), x0_orients and v_desireds (A,) → (dict of (A, ...)
        selected-trajectory tensors, poses_all (A, 4)), both on the device.
        `reach_grids`: an agent-stacked ReachSetGrid
        (`mesh.stack_reach_grids`), needed iff the responsibility weight is
        non-zero.  `phantom_masks`: (A, O) bool marking the phantom
        prediction rows, needed iff the occlusion module is on.  `occ_geom`:
        (ego (A, 2), r_vis (A, K), pts (A, Q, 2), pts_valid (A, Q)), needed
        iff occ_um or occ_ve is weighted."""
        extras = []
        if self.resp_weight != 0.0:
            if reach_grids is None:
                raise ValueError("responsibility weight is non-zero but no "
                                 "reach grids were passed to step()")
            extras.append(reach_grids)
        if self.use_occlusion:
            if phantom_masks is None:
                raise ValueError("occlusion module is enabled but no phantom "
                                 "masks were passed to step()")
            extras.append(torch.as_tensor(phantom_masks, device=self.device))
            if self.use_occ_geom:
                if occ_geom is None:
                    raise ValueError("occ_um/occ_ve are weighted but no occluder "
                                     "geometry was passed to step()")
                ego, r_vis, pts, pts_valid = occ_geom
                extras += [self._tensor(ego), self._tensor(r_vis), self._tensor(pts),
                           torch.as_tensor(pts_valid, device=self.device)]
        v_des = self._tensor(v_desireds)
        ctx = CycleContext(
            ref=self.ref,
            veh=veh,
            weights=weights,
            preds=preds_stacked,
            obstacle_xy=preds_stacked.means[:, :, 0],
            obstacle_valid=preds_stacked.valid[:, :, 0],
            corridor=self.corridors,
            lane_segments=self.lane_segments,
            lane_valid=self.lane_valid,
            x0_orientation=self._tensor(x0_orients),
            desired_velocity=v_des,
            desired_avg_velocity=v_des,
        )
        return self._cycle(self._tensor(matrices),
                           torch.as_tensor(masks, device=self.device), ctx, *extras)
