"""What both entries share: the road on the device, each request's inputs
uploaded in one copy per dtype, and the host's sampling matrices, all
through the program's own functions."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from frenetix_tpu_torch.geometry.corridor import strip_corridor
from frenetix_tpu_torch.geometry.refpath import RefPathTable, prepare_reference_path
from frenetix_tpu_torch.ops import sampling as smp
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER, PredictionTensors
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.planner.core import CycleContext

from portbench import generate

# per-request float inputs in upload order, and the bool ones
FLOATS = ("means", "inv_covs", "covs", "orientations", "velocities", "lengths",
          "widths", "obstacle_xy", "x0_orientation", "desired_velocity",
          "desired_avg_velocity")
BOOLS = ("valid", "obstacle_valid")
GRID_FLOATS = ("grid_origin", "grid_cell")
GRID_BOOLS = ("grid_occupancy", "grid_valid")


class Base:
    def __init__(self, config, lines, device, tracing):
        self.config = config
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        self.np_dtype = np.dtype(config["dtype"])
        self.span = torch.profiler.record_function if tracing else _no_span
        self.dt = config["planning"]["dt"]
        self.n_steps = generate.planning_steps(config)
        self.veh = VehicleParams(**config["vehicle"])
        weights = np.zeros(len(COST_TERM_ORDER))
        for name, w in config["cost_weights"].items():
            weights[COST_TERM_ORDER.index(name)] = w
        self.weights = torch.as_tensor(weights, dtype=self.dtype, device=device)
        tabs = [prepare_reference_path(line, extension=config["road"]["extension_m"],
                                       dtype=self.np_dtype) for line in lines]
        half = config["road"]["corridor_half_width_m"]
        self.ref = RefPathTable(*(torch.as_tensor(np.stack([getattr(t, f) for t in tabs]),
                                                  device=device)
                                  for f in RefPathTable._fields))
        self.corridor = torch.as_tensor(np.stack([strip_corridor(t, half) for t in tabs]),
                                        device=device)
        a = config["agents"]
        self.lane_segments = torch.zeros((a, 0, 2, 2), dtype=self.dtype, device=device)
        self.lane_valid = torch.zeros((a, 0), dtype=torch.bool, device=device)
        self.masks = {}

    def matrix(self, req, a):
        """Agent a's padded sampling matrix and mask, built on the host as
        the planner builds them."""
        x0_lon, x0_lat = tuple(req["x0_lon"][a]), tuple(req["x0_lat"][a])
        t1, ss1, d1 = generate.sampling_ranges(
            self.config, x0_lon, x0_lat, time_samples=smp.time_samples,
            linspace_samples=smp.linspace_samples)
        m = smp.build_sampling_matrix(t1_vals=t1, ss1_vals=ss1, d1_vals=d1,
                                      x0_lon=x0_lon, x0_lat=x0_lat, dtype=self.np_dtype)
        return smp.pad_matrix(m, self.config["sampling"]["bucket"])

    def mask(self, host_mask):
        """The device mask of a request's real rows (one per distinct mask)."""
        key = host_mask.tobytes()
        if key not in self.masks:
            self.masks[key] = torch.as_tensor(host_mask, device=self.device)
        return self.masks[key]

    def packed(self, req, floats, bools):
        """Host buffers of a request's inputs, made once per pool request:
        the floats in the program's dtype, the bools as bytes, and the
        names and shapes of each."""
        f = np.concatenate([np.asarray(req[k], self.np_dtype).ravel() for k in floats])
        b = np.concatenate([np.asarray(req[k], bool).ravel() for k in bools])
        return (f, [(k, np.shape(req[k])) for k in floats],
                b.view(np.uint8), [(k, np.shape(req[k])) for k in bools])

    def upload(self, packed):
        """The request's inputs on the device: one copy per dtype, split
        into views."""
        f, f_shapes, b, b_shapes = packed
        out = {}
        for flat, shapes in ((torch.from_numpy(f).to(self.device), f_shapes),
                             (torch.from_numpy(b).to(self.device).view(torch.bool),
                              b_shapes)):
            at = 0
            for k, shape in shapes:
                n = int(np.prod(shape))
                out[k] = flat[at:at + n].view(shape)
                at += n
        return out

    def context(self, t, agent_axis: bool) -> CycleContext:
        """The cycle's context of the uploaded inputs `t` over the road."""
        def pick(x):
            return x if agent_axis else x[0]

        preds = PredictionTensors(**{k: pick(t[k]) for k in PredictionTensors._fields})
        return CycleContext(
            ref=RefPathTable(*(pick(x) for x in self.ref)), veh=self.veh,
            weights=self.weights, preds=preds, obstacle_xy=pick(t["obstacle_xy"]),
            obstacle_valid=pick(t["obstacle_valid"]), corridor=pick(self.corridor),
            lane_segments=pick(self.lane_segments), lane_valid=pick(self.lane_valid),
            x0_orientation=pick(t["x0_orientation"]),
            desired_velocity=pick(t["desired_velocity"]),
            desired_avg_velocity=pick(t["desired_avg_velocity"]))


@contextlib.contextmanager
def _no_span(name):
    yield
