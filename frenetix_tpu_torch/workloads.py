"""Replanning-cycle problems built without JAX, for timing and checks.

`dense_cycle_problem` is the port's counterpart of `bench.py::build_workload`
(the dense sampling sweep of BASELINE.json): a 60° arc of radius 150 m as
reference path (R = 868 rows at ds ≈ 0.25 m), a ±3.5 m drivable corridor,
4 predicted obstacles ahead, and the level-5 velocity/lateral grids, i.e.
34,320 candidates padded to M = 34,816, over N + 1 = 31 steps.

`stacked_cycle_problem` is the port's counterpart of
`bench_scaling.py::build_stacked_problem`: A agents on arcs shifted sideways,
±4 m corridors, one shared sampling matrix (7 × 9 × 9 = 567 candidates,
padded to the bucket), 4 predicted obstacles per agent, stacked along the
agent axis for `parallel.mesh.batched_full_cycle`.  With `ragged=True` the
agents' arcs differ in length, so their tables have different R and are
padded to a common one.  With `o_slots` the predictions are padded to that
many obstacle slots (the simulations' 16) and obstacle 0 of every agent
stands next to the candidates' end points, so that the risk stack has risk
to price; `stacked_post_pass_extras` makes the reach grids, phantom masks and
occluder geometry that the batched cycle's post-passes take.

`initial_state_problem` puts A agents on rotated copies of one S-bend, each
a few metres beside its path with a heading, speed and steering drawn from a
seed: the inputs of `planner.initial_state.compute_initial_state`.

`device_fleet` builds S device-resident simulations for
`parallel.device_sim.run_fleet`: members cycle through the highway, the
overtake with its lead as a second agent, the curve and the convoy of eight
agents, each with gaps and speeds drawn from a seed, so that no two members
are the same run.

`write_synthetic_walenet_onnx` writes an ONNX file with the I/O contract of
the Wale-Net export that `models.walenet` reads (`WALENET_ONNX_PATH`):
inputs `hist` (30, B, 2), `nbrs` (30, 39·B, 2), `sc_img` (B, 1, 256, 256),
output `predictions` (40, B, 5), with weights drawn from a seed.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from frenetix_tpu_torch.geometry.corridor import strip_corridor
from frenetix_tpu_torch.geometry.refpath import prepare_reference_path
from frenetix_tpu_torch.ops.sampling import (
    build_sampling_matrix, linspace_samples, pad_matrix, time_samples,
)
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.planner.core import context_from_numpy
from frenetix_tpu_torch.risk.reachable_set import ReachSetGrid

__all__ = ["dense_cycle_problem", "stacked_cycle_problem",
           "stacked_post_pass_extras", "initial_state_problem", "device_fleet",
           "write_synthetic_walenet_onnx"]

N_STEPS = 30
DT = 0.1


def _dense_cycle_numpy(dtype=np.float32, density=5, bucket=1024):
    """Host arrays of the dense cycle: (matrix, mask, context fields), with
    the context fields named as `planner.core.context_from_numpy` takes them."""
    t = np.linspace(0, np.pi / 3, 600)
    center = np.stack([150 * np.sin(t), 150 * (1 - np.cos(t))], axis=1)
    ref = prepare_reference_path(center, extension=30.0, dtype=dtype)
    corridor = strip_corridor(ref, 3.5)

    x0_lon = (40.0, 10.0, 0.0)
    x0_lat = (0.3, 0.0, 0.0)
    t1 = np.unique(np.concatenate([time_samples(1.1, 3.0, DT, 2), [N_STEPS * DT]]))
    ss1 = np.union1d(linspace_samples(5.0, 15.0, density), [x0_lon[1]])
    d1 = np.union1d(linspace_samples(-3.0, 3.0, density), [x0_lat[0]])
    matrix = build_sampling_matrix(
        t1_vals=t1, ss1_vals=ss1, d1_vals=d1, x0_lon=x0_lon, x0_lat=x0_lat,
        dtype=dtype,
    )
    matrix, mask = pad_matrix(matrix, bucket=bucket)

    o, t_pred = 4, N_STEPS
    means = np.zeros((o, t_pred, 2), dtype)
    for k in range(o):
        s_obs = 55.0 + 12.0 * k + 8.0 * DT * np.arange(t_pred)
        means[k, :, 0] = np.interp(s_obs, ref.s, ref.xy[:, 0])
        means[k, :, 1] = np.interp(s_obs, ref.s, ref.xy[:, 1])
    covs = np.tile(np.eye(2, dtype=dtype) * 0.5, (o, t_pred, 1, 1))
    preds = dict(
        means=means,
        inv_covs=np.linalg.inv(covs).astype(dtype),
        covs=covs,
        orientations=np.zeros((o, t_pred), dtype),
        velocities=np.full((o, t_pred), 8.0, dtype),
        lengths=np.full((o,), 4.5, dtype),
        widths=np.full((o,), 1.8, dtype),
        valid=np.ones((o, t_pred), bool),
    )
    weights = np.zeros(len(COST_TERM_ORDER), dtype)
    for name, w in dict(
        lateral_jerk=0.2, longitudinal_jerk=0.2, velocity_offset=1.0,
        distance_to_reference_path=5.0, prediction=0.2,
    ).items():
        weights[COST_TERM_ORDER.index(name)] = w
    fields = dict(
        ref=ref,
        veh=VehicleParams(),
        weights=weights,
        preds=preds,
        obstacle_xy=means[:, 0],
        obstacle_valid=preds["valid"][:, 0],
        corridor=corridor,
        lane_segments=np.zeros((0, 2, 2), dtype),
        lane_valid=np.zeros((0,), bool),
        x0_orientation=np.asarray(0.27, dtype),
        desired_velocity=np.asarray(12.0, dtype),
        desired_avg_velocity=np.asarray(12.0, dtype),
    )
    return matrix, mask, fields


def dense_cycle_problem(device: torch.device, dtype=torch.float32, density=5,
                        bucket=1024):
    """(matrix, mask, ctx, dt, n_steps, n_valid) of the dense cycle on
    `device`, ready for `planner.core.evaluate_cycle`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    matrix, mask, fields = _dense_cycle_numpy(np_dtype, density, bucket)
    ctx = context_from_numpy(**fields, device=device, dtype=dtype)
    return (torch.as_tensor(matrix, dtype=dtype, device=device),
            torch.as_tensor(mask, device=device), ctx, DT, N_STEPS,
            int(mask.sum()))


def _pad_slots(arr, o_slots):
    """First axis zero-padded to `o_slots` rows."""
    pad = np.zeros((o_slots - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def _stacked_cycle_numpy(a: int, dtype=np.float32, n_steps: int = N_STEPS,
                         m_bucket: int = 256, spread: float = 3.0,
                         ragged: bool = False, o_slots=None):
    """Host arrays of the stacked problem: the shared (matrix, mask) and one
    dict of context fields per agent."""
    matrix = build_sampling_matrix(
        t1_vals=np.round(np.arange(1.1, 3.05, 0.3), 2),
        ss1_vals=np.linspace(5, 15, 9), d1_vals=np.linspace(-3, 3, 9),
        x0_lon=(30.0, 10.0, 0.0), x0_lat=(0.0, 0.0, 0.0), dtype=dtype,
    )
    matrix, mask = pad_matrix(matrix, m_bucket)

    o, t_pred = 4, n_steps
    weights = np.zeros(len(COST_TERM_ORDER), dtype)
    weights[COST_TERM_ORDER.index("velocity_offset")] = 1.0
    weights[COST_TERM_ORDER.index("distance_to_reference_path")] = 5.0

    agents = []
    for i in range(a):
        arc = np.pi / 3 * (1.0 + 0.04 * i) if ragged else np.pi / 3
        t = np.linspace(0, arc, 300)
        ref = prepare_reference_path(
            np.stack([150 * np.sin(t) + spread * i, 150 * (1 - np.cos(t))], axis=1),
            extension=20.0, dtype=dtype,
        )
        covs = np.tile(np.eye(2, dtype=dtype) * 0.5, (o, t_pred, 1, 1))
        means = np.tile(np.array([60.0 + spread * i, 5.0], dtype), (o, t_pred, 1))
        if o_slots is not None:
            # obstacle 0 next to the end points of the candidates' fan
            means[0] = np.array([40.0 + spread * i, 5.0], dtype)
        preds = dict(
            means=means, inv_covs=np.linalg.inv(covs).astype(dtype), covs=covs,
            orientations=np.zeros((o, t_pred), dtype),
            velocities=np.full((o, t_pred), 8.0, dtype),
            lengths=np.full((o,), 4.5, dtype), widths=np.full((o,), 1.8, dtype),
            valid=np.ones((o, t_pred), bool),
        )
        if o_slots is not None:
            preds = {k: _pad_slots(v, o_slots) for k, v in preds.items()}
            means = preds["means"]
        agents.append(dict(
            ref=ref, veh=VehicleParams(), weights=weights, preds=preds,
            obstacle_xy=means[:, 0], obstacle_valid=preds["valid"][:, 0],
            corridor=strip_corridor(ref, 4.0).astype(dtype),
            lane_segments=np.zeros((0, 2, 2), dtype),
            lane_valid=np.zeros((0,), bool),
            x0_orientation=np.asarray(0.2, dtype),
            desired_velocity=np.asarray(10.0, dtype),
            desired_avg_velocity=np.asarray(10.0, dtype),
        ))
    return matrix, mask, agents


def stacked_cycle_problem(a: int, device: torch.device, dtype=torch.float32,
                          n_steps: int = N_STEPS, m_bucket: int = 256,
                          spread: float = 3.0, ragged: bool = False, o_slots=None):
    """(matrices (A, M, 13), masks (A, M), stacked ctx, per-agent ctxs, dt,
    n_steps) on `device`: the stacked context for
    `parallel.mesh.batched_full_cycle` and the A single-agent contexts it
    was stacked from, for the sequential `planner.core.evaluate_cycle`."""
    from frenetix_tpu_torch.parallel.mesh import stack_cycle_contexts

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    matrix, mask, agents = _stacked_cycle_numpy(a, np_dtype, n_steps, m_bucket,
                                                spread, ragged, o_slots)
    ctxs = [context_from_numpy(**f, device=device, dtype=dtype) for f in agents]
    matrices = torch.as_tensor(np.tile(matrix[None], (a, 1, 1)), dtype=dtype,
                               device=device)
    masks = torch.as_tensor(np.tile(mask[None], (a, 1)), device=device)
    return matrices, masks, stack_cycle_contexts(ctxs), ctxs, DT, n_steps


def stacked_post_pass_extras(ctx, seed: int = 0, grid_n: int = 64, n_rays: int = 720,
                             n_points: int = 4):
    """The extras of the batched cycle's post-passes for a stacked context of
    `stacked_cycle_problem(..., o_slots=...)`, on its device:

    - an agent-stacked ReachSetGrid in which only obstacle 0 is valid and
      reaches the +y half of its grid at every step, so that the
      responsibility term differs between candidates;
    - phantom masks (A, O) marking obstacle 0;
    - occluder geometry: egos 25 m before obstacle 1, polar maps with ranges
      drawn from `seed` between 8 and 35 m, and `n_points` silhouette points
      around obstacle 0 of which the first two are valid.

    Returns (grid, phantom_masks, (ego, r_vis, pts, pts_valid))."""
    xy = ctx.preds.means[:, :, 0]                          # (A, O, 2)
    a, o = xy.shape[0], xy.shape[1]
    device, dtype = xy.device, xy.dtype
    occupancy = torch.zeros((a, o, 11, grid_n, grid_n), dtype=torch.bool, device=device)
    occupancy[:, 0, :, :, grid_n // 2:] = True
    first = torch.zeros((a, o), dtype=torch.bool, device=device)
    first[:, 0] = True
    grid = ReachSetGrid(origin=xy, occupancy=occupancy, valid=first,
                        cell=torch.full((a, o), 1.5, dtype=dtype, device=device),
                        dt_rs=0.2)
    rng = np.random.default_rng(seed)
    r_vis = torch.as_tensor(rng.uniform(8.0, 35.0, (a, n_rays)), dtype=dtype,
                            device=device)
    offsets = torch.as_tensor(rng.normal(size=(a, n_points, 2)), dtype=dtype,
                              device=device)
    pts_valid = torch.zeros((a, n_points), dtype=torch.bool, device=device)
    pts_valid[:, :2] = True
    ego = xy[:, 1] - torch.tensor([25.0, 3.0], dtype=dtype, device=device)
    return grid, first.clone(), (ego, r_vis, xy[:, :1] + offsets, pts_valid)


def initial_state_problem(n_agents: int, device: torch.device, dtype=torch.float64,
                          seed: int = 19):
    """(stacked reference tables (A, R), CartesianState of (A,) tensors, the
    per-agent NumPy tables, the per-agent CartesianStates of floats) for
    `planner.initial_state.compute_initial_state` and its NumPy form."""
    from frenetix_tpu_torch.geometry.refpath import RefPathTable
    from frenetix_tpu_torch.planner.initial_state import CartesianState

    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 120.0, 400)
    base = np.stack([x, 6.0 * np.sin(x / 25.0)], axis=1)
    refs, rows = [], []
    for a in range(n_agents):
        ang = 0.3 * a
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        ref = prepare_reference_path(base @ rot.T + [5.0 * a, 0.0], dtype=np.float64)
        i, d = int(rng.uniform(60, 360)), rng.uniform(-2.0, 2.0)
        th = ref.theta[i]
        rows.append(CartesianState(
            x=ref.xy[i, 0] - d * np.sin(th), y=ref.xy[i, 1] + d * np.cos(th),
            orientation=th + rng.uniform(-0.2, 0.2), velocity=rng.uniform(3.0, 15.0),
            acceleration=rng.uniform(-1.0, 1.0), steering_angle=rng.uniform(-0.1, 0.1),
            yaw_rate=0.0))
        refs.append(ref)
    ref = RefPathTable(*(torch.as_tensor(np.stack([np.asarray(getattr(r, f)) for r in refs]),
                                         dtype=dtype, device=device)
                         for f in RefPathTable._fields))
    state = CartesianState(*(torch.as_tensor(np.array(col, dtype=np.float64), dtype=dtype,
                                             device=device) for col in zip(*rows)))
    return ref, state, refs, rows


def device_fleet(n_members: int, device=None, dtype: str = "float32", seed: int = 0,
                 n_steps=None, config=None):
    """`n_members` DeviceSimulations for `parallel.device_sim.run_fleet`.

    Member i is of family i mod 4: highway (one agent), overtake with
    `start_multiagent` (two agents), curve (one agent), convoy with
    `start_multiagent` (eight agents).  Speeds and gaps vary around the
    factory's defaults by up to ±10 % (speeds) and ±15 % (gaps), drawn from
    `seed`.  `n_steps` shortens every scenario (a CPU rehearsal); `config`
    replaces the default config (its `dtype` and `start_multiagent` are set
    per member).  `device` as in `Simulation`: the CUDA device by default."""
    import copy

    from frenetix_tpu_torch.io import scenario_factory as factory
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils.config import load_config

    rng = np.random.default_rng(seed)
    extra = {} if n_steps is None else {"n_steps": int(n_steps)}
    sims = []
    for i in range(n_members):
        speed, gap = rng.uniform(0.9, 1.1), rng.uniform(0.85, 1.15)
        family = i % 4
        if family == 0:
            scenario = factory.make_highway(ego_v=15.0 * speed, lead_gap=40.0 * gap,
                                            **extra)
        elif family == 1:
            scenario = factory.make_overtake(ego_v=14.0 * speed, lead_gap=35.0 * gap,
                                             **extra)
        elif family == 2:
            scenario = factory.make_curve(ego_v=12.0 * speed, lead_v=8.0 * gap, **extra)
        else:
            scenario = factory.make_convoy(ego_v=10.0 * speed, gap=30.0 * gap, **extra)
        cfg = copy.deepcopy(config) if config is not None else load_config()
        cfg.dtype = dtype
        cfg.simulation.start_multiagent = family in (1, 3)
        sims.append(DeviceSimulation(Simulation(scenario, cfg, device)))
    return sims


# --------------------------------------------------------------------------
# a synthetic Wale-Net export
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1              # a negative int64 as its two's complement
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(fnum: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes or str length-delimited."""
    if isinstance(value, int):
        return _varint(fnum << 3) + _varint(value)
    data = value.encode() if isinstance(value, str) else value
    return _varint((fnum << 3) | 2) + _varint(len(data)) + data


_ONNX_DTYPE = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims (1), data_type (2), name (8), little-endian raw_data (9)."""
    arr = np.asarray(arr)
    out = b"".join(_field(1, int(d)) for d in arr.shape)
    out += _field(2, _ONNX_DTYPE[arr.dtype]) + _field(8, name)
    return out + _field(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())


def _attribute(name: str, value) -> bytes:
    """AttributeProto: name (1), then f (2), i (3), t (5) or ints (8), and
    its type (20)."""
    out = _field(1, name)
    if isinstance(value, float):
        return out + _varint((2 << 3) | 5) + struct.pack("<f", value) + _field(20, 1)
    if isinstance(value, int):
        return out + _field(3, value) + _field(20, 2)
    if isinstance(value, np.ndarray):
        return out + _field(5, _tensor_proto("", value)) + _field(20, 4)
    return out + _field(8, b"".join(_varint(int(v)) for v in value)) + _field(20, 7)


class _OnnxGraphWriter:
    """Nodes and initializers of one GraphProto, in the order they are added."""

    def __init__(self):
        self.nodes, self.inits, self.count = [], [], 0

    def init(self, name: str, arr) -> str:
        self.inits.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def node(self, op: str, inputs, n_out: int = 1, **attrs):
        self.count += 1
        outs = [f"{op.lower()}_{self.count}_{i}" for i in range(n_out)]
        body = b"".join(_field(1, i) for i in inputs)
        body += b"".join(_field(2, o) for o in outs)
        body += _field(3, f"{op}_{self.count}") + _field(4, op)
        body += b"".join(_field(5, _attribute(k, v)) for k, v in attrs.items())
        self.nodes.append(body)
        return outs[0] if n_out == 1 else outs

    def const(self, value) -> str:
        return self.node("Constant", [], value=np.asarray(value))

    def model(self, inputs, outputs) -> bytes:
        graph = b"".join(_field(1, n) for n in self.nodes)
        graph += _field(2, "walenet_synthetic")
        graph += b"".join(_field(5, t) for t in self.inits)
        graph += b"".join(_field(11, _field(1, n)) for n in inputs)
        graph += b"".join(_field(12, _field(1, n)) for n in outputs)
        opset = _field(1, "") + _field(2, 11)
        return (_field(1, 7) + _field(2, "frenetix_tpu_torch.workloads")
                + _field(7, graph) + _field(8, opset))


def write_synthetic_walenet_onnx(path: str, seed: int = 0, *, conv1: int = 32,
                                 conv2: int = 16, embed: int = 32, enc: int = 64,
                                 nbr_feat: int = 32, scene_feat: int = 32,
                                 dec: int = 128) -> str:
    """Write a Wale-Net-shaped ONNX graph (opset 11) to `path`; returns `path`.

    The I/O contract is the real export's: inputs `hist` (30, B, 2), `nbrs`
    (30, 39·B, 2) and `sc_img` (B, 1, 256, 256), output `predictions` (40, B,
    5) with the channels (μx, μy, 1/σx, 1/σy, ρ) in the obstacle frame; its
    first layer is `sc_conv1` (conv1, 1, 3, 3) on the full raster.  Only those
    are known of the real net; its other widths (here `conv2`, `embed`,
    `enc`, `nbr_feat`, `scene_feat`, `dec`) wait for the file, so the
    defaults are guesses of the usual size and the predictions mean nothing
    physically.

    The graph: scene raster → Conv (pads 1) → LeakyRelu → MaxPool 2×2/2 →
    Conv (stride 2) → LeakyRelu → AveragePool 16×16 → Reshape → Gemm; the
    histories of the obstacle and of its 39 grid cells → one shared MatMul +
    Add embedding → GRU encoder (linear_before_reset = 1); the last step of
    `hist` (Gather) and its last displacement (Slice, Transpose, MatMul);
    all concatenated → Gemm → Tanh, repeated over 40 steps (Tile, plus a
    time embedding by Expand) → GRU decoder → MatMul + Add.  μ is the
    constant-velocity extrapolation of the last displacement plus the
    decoder's linear output (weights scaled so that it stays within about a
    metre), 1/σ goes through Exp (about 2 m⁻¹), ρ through Tanh.  Every op of
    the interpreter's Wale-Net list appears at least once, shape chains
    (Shape, Gather, Unsqueeze, Concat, ConstantOfShape) included."""
    rng = np.random.default_rng(seed)

    def weight(shape, fan_in, gain=1.0):
        return (rng.standard_normal(shape) * gain / np.sqrt(fan_in)).astype(np.float32)

    g = _OnnxGraphWriter()
    i64 = np.int64
    # shape data: B, the flattening target (B, -1), (40, B, 2), (40, 1, 1)
    batch = g.node("Unsqueeze", [g.node("Gather", [g.node("Shape", ["sc_img"]),
                                                   g.const(np.array(0, i64))], axis=0)],
                   axes=[0])
    flat = g.node("Concat", [batch, g.const(np.array([-1], i64))], axis=0)
    steps40 = g.const(np.array([40], i64))

    # scene encoder
    x = g.node("Conv", ["sc_img", g.init("sc_conv1.weight",
                                         weight((conv1, 1, 3, 3), 9, 1.0 / 255.0)),
                        g.init("sc_conv1.bias", np.zeros(conv1, np.float32))],
               kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1])
    x = g.node("MaxPool", [g.node("LeakyRelu", [x], alpha=0.1)],
               kernel_shape=[2, 2], strides=[2, 2])
    x = g.node("Conv", [x, g.init("sc_conv2.weight", weight((conv2, conv1, 3, 3), 9 * conv1)),
                        g.init("sc_conv2.bias", np.zeros(conv2, np.float32))],
               kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[2, 2])
    x = g.node("AveragePool", [g.node("LeakyRelu", [x], alpha=0.1)],
               kernel_shape=[16, 16], strides=[16, 16])
    x = g.node("Gemm", [g.node("Reshape", [x, flat]),
                        g.init("sc_fc.weight", weight((scene_feat, conv2 * 16), conv2 * 16)),
                        g.init("sc_fc.bias", np.zeros(scene_feat, np.float32))], transB=1)
    scene = g.node("LeakyRelu", [x], alpha=0.1)

    # history encoders: one embedding and one GRU for the obstacle and its
    # neighbour cells
    emb_w = g.init("ip_emb.weight_t", weight((2, embed), 2, 1.0 / 20.0))
    emb_b = g.init("ip_emb.bias", np.zeros(embed, np.float32))
    gru_w = [g.init("enc_lstm.W", weight((1, 3 * enc, embed), embed)),
             g.init("enc_lstm.R", weight((1, 3 * enc, enc), enc)),
             g.init("enc_lstm.B", np.zeros((1, 6 * enc), np.float32))]

    def encode(seq):
        e = g.node("LeakyRelu", [g.node("Add", [g.node("MatMul", [seq, emb_w]), emb_b])],
                   alpha=0.1)
        return g.node("GRU", [e, *gru_w], n_out=2, hidden_size=enc,
                      linear_before_reset=1)[1]                  # Y_h (1, ·, enc)

    hist_enc = g.node("Squeeze", [encode("hist")], axes=[0])
    nbr = g.node("Reshape", [g.node("Transpose", [encode("nbrs")], perm=[1, 0, 2]), flat])
    nbr_enc = g.node("LeakyRelu", [g.node("Gemm", [
        nbr, g.init("dyn_emb.weight", weight((nbr_feat, 39 * enc), 39 * enc)),
        g.init("dyn_emb.bias", np.zeros(nbr_feat, np.float32))], transB=1)], alpha=0.1)
    last = g.node("Gather", ["hist", g.const(np.array(29, i64))], axis=0)      # (B, 2)
    two = g.node("Slice", ["hist", g.const(np.array([28], i64)),
                           g.const(np.array([np.iinfo(i64).max], i64)),
                           g.const(np.array([0], i64))])                    # (2, B, 2)
    vel = g.node("MatMul", [g.node("Transpose", [two], perm=[1, 2, 0]),
                            g.init("last_step.weight", np.array([[-1.0], [1.0]], np.float32))])
    vel = g.node("Reshape", [vel, flat])                                     # (B, 2)

    # decoder
    feat = enc + nbr_feat + scene_feat + 4
    x = g.node("Concat", [hist_enc, nbr_enc, scene, vel, last], axis=1)
    x = g.node("Tanh", [g.node("Gemm", [
        x, g.init("dec_in.weight", weight((enc, feat), feat)),
        g.init("dec_in.bias", np.zeros(enc, np.float32))], transB=1)])
    reps = g.node("Concat", [steps40, g.node("ConstantOfShape", [g.const(np.array([2], i64))],
                                             value=np.ones(1, i64))], axis=0)
    x = g.node("Tile", [g.node("Unsqueeze", [x], axes=[0]), reps])         # (40, B, enc)
    t_shape = g.node("Concat", [steps40, batch, g.const(np.array([enc], i64))], axis=0)
    x = g.node("Add", [x, g.node("Expand", [
        g.init("dec_time.weight", weight((40, 1, enc), 1, 0.1)), t_shape])])
    x = g.node("Add", [x, g.node("ConstantOfShape", [g.const(np.array([enc], i64))],
                                 value=np.zeros(1, np.float32))])
    y = g.node("GRU", [x, g.init("dec_lstm.W", weight((1, 3 * dec, enc), enc)),
                       g.init("dec_lstm.R", weight((1, 3 * dec, dec), dec)),
                       g.init("dec_lstm.B", np.zeros((1, 6 * dec), np.float32))],
               n_out=2, hidden_size=dec, linear_before_reset=1)[0]          # (40, 1, B, dec)
    out_w = weight((dec, 5), dec) * np.array([0.5, 0.5, 0.1, 0.1, 0.1], np.float32)
    out_b = np.array([0.0, 0.0, np.log(2.0), np.log(2.0), 0.0], np.float32)
    raw = g.node("Add", [g.node("MatMul", [g.node("Squeeze", [y], axes=[1]),
                                            g.init("op.weight_t", out_w)]),
                         g.init("op.bias", out_b)])                          # (40, B, 5)

    # heads: μ = constant velocity + the linear channels, 1/σ = exp, ρ = tanh
    ramp = g.init("cv_ramp", np.arange(1, 41, dtype=np.float32)[:, None])
    cv = g.node("MatMul", [ramp, g.node("Reshape", [vel, g.const(np.array([1, -1], i64))])])
    cv = g.node("Reshape", [cv, g.node("Concat", [steps40, batch,
                                                  g.const(np.array([2], i64))], axis=0)])

    def channels(lo, hi, **steps):
        ins = [raw, g.const(np.array([lo], i64)), g.const(np.array([hi], i64)),
               g.const(np.array([2], i64))]
        if steps:
            ins.append(g.const(np.array([1], i64)))
        return g.node("Slice", ins)

    mu = g.node("Add", [cv, channels(0, 2)])
    sig = g.node("Exp", [channels(2, 4)])
    rho = g.node("Tanh", [channels(4, np.iinfo(i64).max, steps=True)])
    out = g.node("Concat", [mu, sig, rho], axis=2)
    g.count += 1
    g.nodes.append(_field(1, out) + _field(2, "predictions") + _field(3, "Identity_out")
                   + _field(4, "Identity"))
    with open(path, "wb") as f:
        f.write(g.model(["hist", "nbrs", "sc_img"], ["predictions"]))
    return path
