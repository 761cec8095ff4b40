"""Wale-Net trajectory predictor: PyTorch port of `frenetix_tpu/models/walenet.py`.

The network runs through the port's ONNX interpreter
(`onnx_torch.build_torch_fn`) on the simulation's device, batched over all
obstacles of a call, in float32 whatever the simulation's dtype (the JAX
package's net is float32 too: its weights and inputs are).  Per call, one
host→device copy of (hist, nbrs, sc_img), the net as one compiled program
(`utils.compiled`: a CUDA graph per export, device and batch size B, as JAX
jits it) and one device→host copy of the (T, B, 5) output.  Preprocessing
(scene raster, neighbour grid) and postprocessing (frames, covariances) are
NumPy copies of the JAX module's, the raster by its NumPy route (the port
has no native rasterizer).

Model I/O (the reference's wale_net.py:209-341): hist (30, B, 2), nbrs
(30, 39·B, 2), sc_img (B, 1, 256, 256) → predictions (40, B, 5) = (μx, μy,
1/σx, 1/σy, ρ) in each obstacle's frame (rotation orientation − π/2,
translation its current position).

`WALENET_ONNX_PATH` (the environment variable, read at import; the module
attribute at each `WaleNet` construction) names the export; by default the
reference's `wale_net_lite/wale-net.onnx` beside this package.  That file is
not in the repository: `workloads.write_synthetic_walenet_onnx` writes a
graph with the same I/O contract.  A missing or unreadable file raises; no
other predictor stands in.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from frenetix_tpu_torch import default_device
from frenetix_tpu_torch.models.onnx_lite import load_onnx
from frenetix_tpu_torch.models.onnx_torch import build_torch_fn
from frenetix_tpu_torch.utils.compiled import compiled

__all__ = ["WaleNet", "walenet_predictions", "WALENET_ONNX_PATH"]

WALENET_ONNX_PATH = os.environ.get(
    "WALENET_ONNX_PATH",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "wale_net_lite", "wale-net.onnx"))

IN_LENGTH = 30
GRID = (13, 3)
WATCH_RADIUS = 64.0
RES = 256
WINDOW = (18.0, 78.0)  # neighbor window [m] (preprocessing.py:196)


def _rot_mat(theta):
    return np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )


class WaleNet:
    """Batched Wale-Net inference for one scenario on one device."""

    # one interpreter per (export path, device): the weights are uploaded once
    _net_cache: dict = {}

    def __init__(self, scenario, onnx_path: str = None, device=None):
        self.scenario = scenario
        self.device = torch.device(device) if device is not None else default_device()
        path = onnx_path or WALENET_ONNX_PATH
        key = (path, str(self.device))
        if key not in WaleNet._net_cache:
            WaleNet._net_cache[key] = build_torch_fn(load_onnx(path), self.device,
                                                     torch.float32)
        self._net = WaleNet._net_cache[key]
        self._boundaries = self._scenario_boundaries(scenario)

    # ------------------------------------------------------------ preprocess
    @staticmethod
    def _scenario_boundaries(scenario):
        """Lanelet boundary polylines + brightness values
        (preprocessing.py:31-41: road-boundary 255, lane-marking 127)."""
        bounds = []
        for ll in scenario.lanelets.values():
            bounds.append((ll.left_vertices, 255 if ll.adj_left is None else 127))
            bounds.append((ll.right_vertices, 255 if ll.adj_right is None else 127))
        return bounds

    def _render_scene(self, pos, orient):
        """256×256 raster of boundary lines in the vehicle frame
        (generate_self_rendered_sc_img, preprocessing.py:17-194)."""
        pixel_dist = 2 * WATCH_RADIUS / RES
        img = np.zeros((RES, RES), np.float32)
        rot = np.array(
            [[np.cos(orient), np.sin(orient)], [-np.sin(orient), np.cos(orient)]]
        )
        for line, value in self._boundaries:
            rel = (line - pos[None, :]) @ rot.T
            # keep segments near the window
            keep = np.max(np.abs(rel), axis=1) <= WATCH_RADIUS * 1.5
            if not keep.any():
                continue
            rel = rel[keep]
            if len(rel) < 2:
                continue
            # densify to sub-pixel spacing along the polyline
            seg = np.linalg.norm(np.diff(rel, axis=0), axis=1)
            s = np.concatenate([[0.0], np.cumsum(seg)])
            if s[-1] <= 0:
                continue
            eval_s = np.arange(0.0, s[-1], pixel_dist * 0.8)
            xs = np.interp(eval_s, s, rel[:, 0])
            ys = np.interp(eval_s, s, rel[:, 1])
            px = (xs // pixel_dist + RES / 2).astype(int)
            py = (ys // pixel_dist + RES / 2).astype(int)
            ok = (px >= 0) & (px < RES) & (py >= 0) & (py < RES)
            img[py[ok], px[ok]] = value
        return img

    def _obstacle_positions(self, ob, t_lo, t_hi):
        """Positions for steps [t_lo, t_hi]; NaN where absent."""
        out = np.full((t_hi - t_lo + 1, 2), np.nan)
        for i, t in enumerate(range(t_lo, t_hi + 1)):
            st = ob.state_at_time(t)
            if st is not None:
                out[i] = st.position
        return out

    def _preprocess(self, obstacle_ids, time_step, world=None):
        """Batched hist/nbrs/sc_img arrays + per-obstacle frames
        (wale_net.py:367-453 + step_multi batching :261-309).

        `world`: optional scenario-like obstacle source (sim.world_view.
        WorldView): in multi-agent simulations histories and neighbour grids
        read the agents' executed states, not their stale recordings."""
        world = world if world is not None else self.scenario
        b = len(obstacle_ids)
        ncells = GRID[0] * GRID[1]
        hist = np.zeros((IN_LENGTH, b, 2), np.float32)
        nbrs = np.zeros((IN_LENGTH, ncells * b, 2), np.float32)
        sc = np.zeros((b, 1, RES, RES), np.float32)
        frames = []

        all_obs = world.dynamic_obstacles
        for bi, oid in enumerate(obstacle_ids):
            ob = world.obstacles[oid]
            st_now = ob.state_at_time(time_step)
            if st_now is None:
                frames.append((np.zeros(2), 0.0))
                continue
            translation = np.array(st_now.position, float)
            rotation = st_now.orientation - np.pi / 2.0  # wale_net.py:404
            frames.append((translation, rotation))
            rot = _rot_mat(rotation)

            h = self._obstacle_positions(ob, time_step - IN_LENGTH + 1, time_step)
            h = (h - translation[None]) @ rot  # transform_trajectories: tr @ rot_mat
            hist[:, bi, :] = np.nan_to_num(h)

            # neighbor grid (generate_nbr_array, preprocessing.py:196-237)
            r1 = [-WINDOW[0] / 2.0, -WINDOW[1] / 2.0]
            r2 = [WINDOW[0] / 2.0, WINDOW[1] / 2.0]
            grid = np.zeros((GRID[1], GRID[0], IN_LENGTH, 2), np.float32)
            for nb in all_obs:
                st_nb = nb.state_at_time(time_step)
                if st_nb is None:
                    continue
                p = (np.array(st_nb.position) - translation) @ rot
                if not (r1[0] < p[0] < r2[0] and r1[1] < p[1] < r2[1]):
                    continue
                gx = int((p[0] - r1[0]) / (r2[0] - r1[0]) * 3)
                gy = int((r2[1] - p[1]) / (r2[1] - r1[1]) * 13)
                gx = min(gx, GRID[1] - 1)
                gy = min(gy, GRID[0] - 1)
                nh = self._obstacle_positions(nb, time_step - IN_LENGTH + 1, time_step)
                nh = (nh - translation[None]) @ rot
                grid[gx, gy] = np.nan_to_num(nh)
            nbrs[:, bi * ncells : (bi + 1) * ncells, :] = np.swapaxes(
                grid.reshape(ncells, IN_LENGTH, 2), 0, 1
            )

            sc[bi, 0] = self._render_scene(translation, rotation)

        return hist, nbrs, sc, frames

    # --------------------------------------------------------------- predict
    def _run_net(self, hist, nbrs, sc) -> np.ndarray:
        """The net on the device: one host→device copy of the three inputs
        (packed), the compiled net (`_net_program`: one entry per export,
        device and B), one device→host copy of the (T, B, 5) float32
        output."""
        sizes = (hist.size, nbrs.size, sc.size)
        packed = torch.from_numpy(
            np.concatenate([hist.ravel(), nbrs.ravel(), sc.ravel()])).to(self.device)
        h, n, s = torch.split(packed, sizes)
        out = _net_program(self._net, h.view(hist.shape), n.view(nbrs.shape),
                           s.view(sc.shape))
        return out.cpu().numpy()

    def predict(self, obstacle_ids, time_step, world=None):
        """→ {obstacle_id: (pos_list (T, 2), cov_list (T, 2, 2))} in world
        frame (postprocessing per geometry.transform_back).  `world`: see
        `_preprocess`."""
        if not obstacle_ids:
            return {}
        hist, nbrs, sc, frames = self._preprocess(obstacle_ids, time_step,
                                                  world=world)
        fut = self._run_net(hist, nbrs, sc)  # (T, B, 5)

        out = {}
        eps = np.finfo(np.float64).eps
        for bi, oid in enumerate(obstacle_ids):
            translation, rotation = frames[bi]
            pred = fut[:, bi, :].astype(np.float64)  # (T, 5)
            rot_back = _rot_mat(-rotation)
            pos = pred[:, :2] @ rot_back + translation[None]
            sigma_x = 1.0 / (pred[:, 2] + eps)
            sigma_y = 1.0 / (pred[:, 3] + eps)
            rho = pred[:, 4]
            cov = np.empty((pred.shape[0], 2, 2))
            cov[:, 0, 0] = sigma_x**2
            cov[:, 1, 1] = sigma_y**2
            cov[:, 0, 1] = cov[:, 1, 0] = rho * sigma_x * sigma_y
            cov = rot_back.T @ cov @ rot_back  # (T, 2, 2) via broadcasting
            out[oid] = (pos, cov)
        return out


@compiled(static=("net",))
def _net_program(net, hist, nbrs, sc_img) -> torch.Tensor:
    """The net's (T, B, 5) predictions; one program per interpreter (export
    and device) and input shape (JAX jits the net the same way,
    `WaleNet._jit_cache`)."""
    return net(hist=hist, nbrs=nbrs, sc_img=sc_img)[0]


# the net of the last scenario asked for, per device (one entry)
_WALENET_CACHE: dict = {}


def walenet_predictions(
    scenario, obstacle_ids, current_step, horizon, *, max_obstacles=16,
    dtype=np.float32, safety_margin_length=0.5, safety_margin_width=0.2,
    world=None, device=None,
):
    """sim.prediction-compatible entry: PredictionTensors field dict (host
    NumPy).  `world`: optional live obstacle source (WaleNet._preprocess).
    `device`: where the net runs, the CUDA device by default."""
    device = torch.device(device) if device is not None else default_device()
    key = (id(scenario), str(device))
    if key not in _WALENET_CACHE:
        _WALENET_CACHE.clear()
        _WALENET_CACHE[key] = WaleNet(scenario, device=device)
    net = _WALENET_CACHE[key]

    src = world if world is not None else scenario
    obstacles = src.obstacles
    ids = [
        oid for oid in list(obstacle_ids)[:max_obstacles]
        if oid in obstacles
        and obstacles[oid].role == "dynamic"
        and obstacles[oid].state_at_time(current_step) is not None
    ]
    preds = net.predict(ids, current_step, world=world)

    o = max_obstacles
    means = np.zeros((o, horizon, 2), dtype)
    orientations = np.zeros((o, horizon), dtype)
    velocities = np.zeros((o, horizon), dtype)
    covs = np.tile(np.eye(2, dtype=dtype)[None, None] * 0.1, (o, horizon, 1, 1))
    lengths = np.full(o, 4.5, dtype)
    widths = np.full(o, 2.0, dtype)
    valid = np.zeros((o, horizon), bool)

    dt = scenario.dt
    for k, oid in enumerate(ids):
        pos, cov = preds[oid]
        t = min(horizon, pos.shape[0])
        means[k, :t] = pos[:t]
        covs[k, :t] = cov[:t]
        if t < horizon:  # extend with the last prediction
            means[k, t:] = pos[t - 1]
            covs[k, t:] = cov[t - 1]
        valid[k, :t] = True
        ob = src.obstacles[oid]
        st = ob.state_at_time(current_step)
        # orientation/velocity enrichment (prediction_helpers.py:113-173)
        diffs = np.diff(means[k], axis=0)
        seg = np.linalg.norm(diffs, axis=1)
        orient = np.full(horizon, st.orientation)
        prev = st.orientation
        for i in range(1, horizon):
            if seg[i - 1] ** 2 > 1e-8:
                prev = np.arctan2(diffs[i - 1, 1], diffs[i - 1, 0])
            orient[i] = prev
        orientations[k] = orient
        velocities[k, 0] = st.velocity
        velocities[k, 1:] = seg / dt
        lengths[k] = ob.length + safety_margin_length
        widths[k] = ob.width + safety_margin_width

    # symmetrize + regularize for inversion
    covs = 0.5 * (covs + np.swapaxes(covs, -1, -2))
    covs[..., 0, 0] = np.maximum(covs[..., 0, 0], 1e-4)
    covs[..., 1, 1] = np.maximum(covs[..., 1, 1], 1e-4)
    inv = np.linalg.inv(covs.astype(np.float64)).astype(dtype)
    return dict(
        means=means, covs=covs.astype(dtype), inv_covs=inv,
        orientations=orientations, velocities=velocities,
        lengths=lengths, widths=widths, valid=valid,
    )
