"""Kernel K2 (`csrc/rollout.cu`, wrapper `ops/rollout_kernel.py`): the
candidate rollout on the card against its plain twin.

`ops.kinematics.rollout_candidates` sends CUDA tensors to K2a → K1 → K2b
and CPU tensors to `rollout_candidates_plain`.  On the card, for the same
tensors, every field of the two `Rollout`s is equal bit for bit, in float32
and float64:

- the four regimes (normal, low velocity, quintic stopping, standstill with
  the heading carried), the table window on and off, the corridor columns
  present and absent;
- leading agent axes (8 agents × 1,024 candidates, per-agent tables and
  windows; one table shared by a (2, 4) stack), N + 1 = 31 and 51;
- one K2 launch pair per rollout: a compiled cycle's replays and a device
  run count K2 as they count K1;
- what K2 does not take raises before a launch.

The card's cases carry the `cuda` marker and skip without one; on the card:
`python -m pytest tests/test_torch_rollout_kernel.py -m cuda --noconftest
-q`.  The CPU cases check the dispatch and the kernel's argument block.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.geometry.corridor import strip_corridor
from frenetix_tpu_torch.geometry.refpath import prepare_reference_path
from frenetix_tpu_torch.ops import kinematics as kin
from frenetix_tpu_torch.ops import rollout_kernel
from frenetix_tpu_torch.ops.sampling import build_sampling_matrix, linspace_samples, \
    time_samples
from frenetix_tpu_torch.utils import compiled as C

from torch_parity import c_struct_fields, ctypes_fields, host_count

DT = 0.1
VEH = kin.VehicleParams()
SOURCE = Path(__file__).resolve().parents[1] / "frenetix_tpu_torch" / "csrc" / "rollout.cu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _ref(turn=0.0, shift=(0.0, 0.0)):
    """The bench's 60° arc of radius 150 m (R = 868 rows, above the 768-row
    window), turned and moved."""
    t = np.linspace(0, np.pi / 3, 600)
    xy = np.stack([150 * np.sin(t), 150 * (1 - np.cos(t))], axis=1)
    rot = np.array([[np.cos(turn), -np.sin(turn)], [np.sin(turn), np.cos(turn)]])
    return prepare_reference_path(xy @ rot.T + np.asarray(shift), extension=30.0,
                                  dtype=np.float64)


def _matrix(kind, n_steps=30, level=2):
    """A sampling matrix of one regime: time samples up to the horizon, end
    speeds around v0 (end positions in stopping mode), lateral ends on ±3 m;
    standstill stacks a vehicle at rest and one braking to a halt."""
    if kind == "standstill":
        m1 = build_sampling_matrix(t1_vals=[1.0, 3.0], ss1_vals=[0.0], d1_vals=[0.0, 0.5],
                                   x0_lon=(35.0, 0.0, 0.0), x0_lat=(0.2, 0.0, 0.0))
        m2 = build_sampling_matrix(t1_vals=[1.0, 2.0, 3.0], ss1_vals=[0.0, 0.3, 0.5],
                                   d1_vals=[-0.5, 0.3, 1.0], x0_lon=(35.0, 3.0, -1.0),
                                   x0_lat=(0.2, 0.1, 0.0))
        return np.concatenate([m1, m2])
    v0 = 1.2 if kind == "low_vel" else 10.0
    t1 = np.unique(np.concatenate([time_samples(1.1, 3.0, DT, level), [n_steps * DT]]))
    x0_lon, x0_lat = (35.0, v0, 0.2), (0.4, 0.05, 0.01)
    if kind == "quintic_lon":
        return build_sampling_matrix(t1_vals=t1, ss1_vals=linspace_samples(45.0, 70.0, level),
                                     d1_vals=linspace_samples(-1.0, 1.0, level),
                                     x0_lon=x0_lon, x0_lat=x0_lat)
    return build_sampling_matrix(
        t1_vals=t1, ss1_vals=np.union1d(linspace_samples(max(v0 - 5, 0.001), v0 + 5,
                                                         level), [v0]),
        d1_vals=linspace_samples(-3, 3, level), x0_lon=x0_lon, x0_lat=x0_lat)


def _tensor(a, device, dtype):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _ref_tensors(refs, device, dtype):
    """A RefPathTable of tensors; several tables are stacked on a leading axis."""
    if not isinstance(refs, list):
        return type(refs)(*(_tensor(f, device, dtype) for f in refs))
    return type(refs[0])(*(_tensor(np.stack(f), device, dtype) for f in zip(*refs)))


def _bits(t):
    t = t.contiguous()
    return {torch.float32: lambda: t.view(torch.int32),
            torch.float64: lambda: t.view(torch.int64)}.get(t.dtype, lambda: t)()


def _assert_bitwise(got, want, what):
    for name in kin.Rollout._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "extras":
            assert (g is None) == (w is None), f"{what}: extras"
            if g is None:
                continue
            assert len(g) == len(w), f"{what}: extras"
            g, w = torch.stack(g), torch.stack(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (
            f"{what}: {name} {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        same = _bits(g) == _bits(w)
        assert bool(same.all()), (
            f"{what}: {name} differs at {int((~same).sum())} of {same.numel()} elements, "
            f"first at {tuple(int(i) for i in torch.nonzero(~same)[0])}")


def _both(matrix, ref, x0, *, extras=None, **kw):
    """(K2's rollout, the plain twin's) of the same tensors on the card, and
    the K2 launches the first made."""
    before = host_count("kernel.k2.launches")
    got = kin.rollout_candidates(matrix, ref, VEH, x0_orientation=x0,
                                 extra_ref_tables=extras, **kw)
    launches = host_count("kernel.k2.launches") - before
    want = kin.rollout_candidates_plain(matrix, ref, VEH, x0_orientation=x0,
                                        extra_ref_tables=extras, **kw)
    torch.cuda.synchronize()
    return got, want, launches


# ------------------------------------------------------------------ the CPU


def test_cpu_tensors_run_the_plain_twin():
    ref = _ref()
    cpu = torch.device("cpu")
    matrix = _tensor(_matrix("normal", level=1), cpu, torch.float64)
    kw = dict(dt=DT, n_steps=30, low_vel_mode=False, x0_orientation=0.35,
              extra_ref_tables=_tensor(strip_corridor(ref, 3.5), cpu, torch.float64),
              table_window=768)
    before = host_count("kernel.k2.launches")
    got = kin.rollout_candidates(matrix, _ref_tensors(ref, cpu, torch.float64), VEH, **kw)
    want = kin.rollout_candidates_plain(matrix, _ref_tensors(ref, cpu, torch.float64),
                                        VEH, **kw)
    assert host_count("kernel.k2.launches") == before
    _assert_bitwise(got, want, "cpu")


def test_the_argument_block_matches_the_kernel_source():
    assert ctypes_fields(rollout_kernel._Args) == c_struct_fields(SOURCE)


# ----------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", [768, 0])
@pytest.mark.parametrize("with_extras", [True, False])
@pytest.mark.parametrize("kind", ["normal", "low_vel", "quintic_lon", "standstill"])
def test_k2_equals_the_plain_twin(kind, with_extras, window, dtype, cuda_device):
    ref = _ref()
    matrix = _tensor(_matrix(kind), cuda_device, dtype)
    extras = _tensor(strip_corridor(ref, 3.5), cuda_device, dtype) if with_extras else None
    got, want, launches = _both(
        matrix, _ref_tensors(ref, cuda_device, dtype),
        torch.tensor(0.35, dtype=dtype, device=cuda_device),
        extras=extras, dt=DT, n_steps=30, low_vel_mode=kind == "low_vel",
        quintic_lon=kind == "quintic_lon", table_window=window)
    assert launches == 1
    _assert_bitwise(got, want, f"{kind} {dtype} window {window} extras {with_extras}")
    slots = want.inf_slots.cpu().numpy()
    assert slots[:, 0].any() or kind in ("quintic_lon", "low_vel")
    if kind == "standstill":
        moving = want.s_vel.cpu().numpy() > 0.001
        assert (~moving).any() and moving.any()


def _agents(n_agents, m_rows, n_steps, device, dtype, seed=0):
    """(A, M, 13) matrices of agents at other places, speeds and headings, each
    with its own turned and moved table and corridor; rows of every regime's
    kind mixed, some standing, some far beyond the path's end."""
    rng = np.random.default_rng(seed)
    refs, corridors, matrices = [], [], []
    for a in range(n_agents):
        ref = _ref(0.2 * a, (8.0 * a, -3.0 * a))
        refs.append(ref)
        corridors.append(strip_corridor(ref, 3.0 + 0.25 * a))
        m = _matrix("normal", n_steps)
        m = np.concatenate([m, _matrix("standstill")])
        m = m[rng.integers(0, len(m), m_rows)].copy()
        m[:, 2] += rng.uniform(0.0, 120.0)            # s0 of the agent
        m[:, 3] *= rng.uniform(0.2, 2.5)              # its speed
        m[: m_rows // 50, 2] += 400.0                 # beyond the path
        matrices.append(m)
    x0 = rng.uniform(-0.5, 0.8, n_agents)
    return (_tensor(np.stack(matrices), device, dtype), _ref_tensors(refs, device, dtype),
            _tensor(np.stack(corridors), device, dtype), _tensor(x0, device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_steps", [30, 50])
def test_k2_equals_the_plain_twin_per_agent(n_steps, dtype, cuda_device):
    matrix, ref, corridor, x0 = _agents(8, 1024, n_steps, cuda_device, dtype)
    got, want, launches = _both(matrix, ref, x0, extras=corridor, dt=DT, n_steps=n_steps,
                                low_vel_mode=False, quintic_lon=False, table_window=768)
    assert launches == 1 and got.s.shape == (8, 1024, n_steps + 1)
    _assert_bitwise(got, want, f"8 x 1024, N+1 = {n_steps + 1}, {dtype}")
    assert bool(want.inf_slots[..., 3].any()) and bool((~want.inf_slots[..., 0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("low_vel", [False, True])
def test_k2_equals_the_plain_twin_on_a_shared_table(low_vel, cuda_device):
    dtype = torch.float32
    matrix, _, _, _ = _agents(8, 200, 30, cuda_device, dtype, seed=1)
    ref = _ref()
    got, want, launches = _both(
        matrix.reshape(2, 4, 200, 13), _ref_tensors(ref, cuda_device, dtype),
        _tensor(np.linspace(0.0, 0.7, 8).reshape(2, 4), cuda_device, dtype),
        extras=_tensor(strip_corridor(ref, 3.5), cuda_device, dtype), dt=DT, n_steps=30,
        low_vel_mode=low_vel, quintic_lon=False, table_window=768)
    assert launches == 1 and got.x.shape == (2, 4, 200, 31)
    _assert_bitwise(got, want, f"(2, 4) on one table, low_vel {low_vel}")


@pytest.mark.cuda
def test_k2_launches_once_per_compiled_replay(cuda_device):
    from frenetix_tpu_torch.planner.core import evaluate_cycle
    from frenetix_tpu_torch.workloads import dense_cycle_problem

    matrix, mask, ctx, dt, n_steps, _ = dense_cycle_problem(cuda_device, torch.float32,
                                                            density=2, bucket=256)
    C.clear_all()
    captures = evaluate_cycle.captures        # (cumulative over the process)
    kw = dict(dt=dt, n_steps=n_steps, low_vel_mode=False)
    first = evaluate_cycle(matrix, mask, ctx, **kw)           # warm-up and capture
    k1, k2 = host_count("kernel.k1.launches"), host_count("kernel.k2.launches")
    for _ in range(3):
        again = evaluate_cycle(matrix, mask, ctx, **kw)
    torch.cuda.synchronize()
    assert host_count("kernel.k1.launches") - k1 == 3
    assert host_count("kernel.k2.launches") - k2 == 3
    assert evaluate_cycle.captures - captures == 1
    _assert_bitwise(again.rollout, first.rollout, "replayed against the first call")
    C.clear_all()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [True, False])
def test_k2_launches_in_a_device_run(graph, cuda_device):
    from frenetix_tpu_torch.io import scenario_factory
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation
    from frenetix_tpu_torch.sim.simulation import Simulation
    from frenetix_tpu_torch.utils.config import load_config

    cfg = load_config()
    cfg.simulation.start_multiagent = True
    cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 2
    sim = Simulation(scenario_factory.make_convoy(n_vehicles=2, n_steps=40), cfg,
                     cuda_device)
    sim.max_steps = 12
    run = DeviceSimulation(sim)
    k2 = host_count("kernel.k2.launches")
    res = run.run(graph=graph)
    # a replay adds what its capture recorded, as the eager body counts
    assert host_count("kernel.k2.launches") - k2 == res.extras["k2_launches"]
    # one rollout per program (kinematics mode) and cycle, each around one K1
    assert res.extras["k2_launches"] % run.n_cycles == 0
    assert res.extras["k2_launches"] == res.extras["k1_launches"] > 0


@pytest.mark.cuda
def test_k2_refuses_what_it_does_not_take(cuda_device):
    ref = _ref()
    matrix = _tensor(_matrix("normal", level=1), cuda_device, torch.float32)
    tables = _ref_tensors(ref, cuda_device, torch.float32)
    kw = dict(dt=DT, n_steps=30, low_vel_mode=False, x0_orientation=0.35)
    before = host_count("kernel.k2.launches"), host_count("kernel.k1.launches")
    with pytest.raises(TypeError):
        kin.rollout_candidates(matrix.half(), _ref_tensors(ref, cuda_device, torch.half),
                               VEH, **kw)
    with pytest.raises(TypeError):
        kin.rollout_candidates(matrix, _ref_tensors(ref, cuda_device, torch.float64),
                               VEH, **kw)
    with pytest.raises(ValueError):
        kin.rollout_candidates(matrix, _ref_tensors(ref, torch.device("cpu"),
                                                    torch.float32), VEH, **kw)
    with pytest.raises(ValueError):
        kin.rollout_candidates(matrix[:, :12], tables, VEH, **kw)
    with pytest.raises(ValueError):
        kin.rollout_candidates(matrix[None].expand(3, -1, -1),
                               _ref_tensors([ref, ref], cuda_device, torch.float32), VEH,
                               **kw)
    assert (host_count("kernel.k2.launches"), host_count("kernel.k1.launches")) == before
