"""Kernel Q (`csrc/risk_quadrature.cu`) against the plain twin on the card.

`collision_probability_fast` sends CUDA tensors to Q; `plain=True` runs the
plain twin on the same tensors on the card.  In float32 and float64, with
leading axes (), (A,) and (S, A), M not a multiple of Q's block, O = 1 and
16, and t below the rollout's N:

- wherever the slot is invalid or the cell lies beyond the 5 m gate, Q
  writes +0.0 and the twin gives 0; cells placed on the gate (5 m, and one
  ulp either side) fall on the same side in both;
- on the priced cells Q is within 1e-6 (float32) / 1e-13 (float64) of the
  twin; both add the same operations in the same order, so most cells are
  bitwise equal;
- one launch per call; replayed inside `utils.compiled` equals eager
  bitwise; with tracing on, `risk.quadrature.useful` equals the twin's
  count of cells inside the gate of a valid slot;
- a dtype Q does not take, tensors on two devices, and leading
  prediction axes other than the rollout's raise before any launch.

Every test here needs the card (`cuda` marker) and skips without one; on
the card: `python -m pytest tests/test_torch_risk_quadrature.py -m cuda
--noconftest -q`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.ops.costs import PredictionTensors
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.risk import probability
from frenetix_tpu_torch.utils import compiled as C
from frenetix_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-6, torch.float64: 1e-13}
VEH = VehicleParams()


class _Rollout(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    theta_gl: torch.Tensor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    C.clear_all()


def _launches():
    return tracing.COUNTERS.get("kernel.q.launches", 0)


def _problem(lead, m, o, n1, horizon, dtype, device, seed=0):
    """Candidates driving along x at 8-14 m/s with lateral offsets; obstacle
    slots beside and ahead of them, some beyond the gate, some invalid
    inside it, correlated and zero covariances.  Candidate 0 of every lead
    index stands at the origin, and slot 0 lies on the gate: its centre
    5 m away, or one ulp nearer or farther, its front and back points
    farther."""
    rng = np.random.default_rng(seed)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    k = np.arange(n1) * 0.1
    v = rng.uniform(8.0, 14.0, lead + (m, 1))
    x = 20.0 + v * k
    y = rng.uniform(-3.0, 3.0, lead + (m, 1)) + 0.2 * np.sin(k)
    y = np.broadcast_to(y, lead + (m, n1)).copy()
    theta = np.arctan2(np.gradient(y, axis=-1), np.gradient(x, axis=-1))
    x[..., 0, :], y[..., 0, :] = 0.0, 0.0

    steps = np.arange(horizon) * 0.1
    ahead = rng.uniform(-10.0, 30.0, lead + (o, 1))
    means = np.stack([20.0 + ahead + rng.uniform(5.0, 14.0, lead + (o, 1)) * steps,
                      np.broadcast_to(rng.uniform(-4.0, 4.0, lead + (o, 1)),
                                      lead + (o, horizon))], axis=-1)
    orient = rng.normal(0.0, 0.3, lead + (o, horizon))
    if o > 1:   # some slots far beyond the gate
        means[..., o // 2:, :, 0] += 60.0
    five = np_dtype(5.0)
    on_gate = np.array([five, np.nextafter(five, np_dtype(0.0)),
                        np.nextafter(five, np_dtype(10.0))])
    means[..., 0, :, 0] = np.resize(on_gate, horizon)
    means[..., 0, :, 1] = 0.0
    orient[..., 0, :] = np.pi / 2
    a = rng.normal(0.0, 0.6, lead + (o, horizon, 2, 2))
    covs = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(2)
    if o > 2:
        covs[..., 2, :, :, :] = 0.0                     # ground truth: 0.1·I
    valid = rng.uniform(size=lead + (o, horizon)) < 0.8
    valid[..., 0, :] = True

    def t(arr, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dt, device=device)

    ro = _Rollout(x=t(x), y=t(y), theta_gl=t(theta))
    preds = PredictionTensors(
        means=t(means), inv_covs=t(np.linalg.inv(covs + 0.1 * np.eye(2))), covs=t(covs),
        orientations=t(orient), velocities=t(np.ones(lead + (o, horizon))),
        lengths=t(rng.uniform(0.5, 5.0, lead + (o,))),
        widths=t(rng.uniform(0.4, 2.0, lead + (o,))), valid=t(valid, torch.bool))
    return ro, preds


def _gate(ro, preds, t):
    """(…, M, O, t) cells inside the 5 m gate, by the twin's formula."""
    ego = torch.stack([ro.x[..., 1:t + 1], ro.y[..., 1:t + 1]], dim=-1)
    yaw = preds.orientations[..., 1:t + 1]
    half = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1) * (
        preds.lengths[..., None, None] / 2.0)
    centre = preds.means[..., :t, :]
    dists = [torch.sqrt(torch.sum((p.unsqueeze(-4) - ego.unsqueeze(-3)) ** 2, dim=-1))
             for p in (centre, centre + half, centre - half)]
    return torch.amin(torch.stack(dists), dim=0) <= 5.0


def _priced(ro, preds, t):
    """(…, M, O, t) cells inside the 5 m gate of a valid slot."""
    return _gate(ro, preds, t) & preds.valid[..., None, :, :t]


CASES = [  # (leading axes, M, O, N + 1, prediction horizon)
    ((), 37, 16, 31, 31),
    ((3,), 300, 1, 31, 12),
    ((2, 3), 130, 16, 9, 31),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=["lead0", "lead1_t11", "lead2_short"])
def test_q_matches_the_plain_twin(case, dtype, cuda_device):
    lead, m, o, n1, horizon = case
    ro, preds = _problem(lead, m, o, n1, horizon, dtype, cuda_device)
    got, t = probability.collision_probability_fast(ro, preds, VEH)
    want, t_plain = probability.collision_probability_fast(ro, preds, VEH, plain=True)
    torch.cuda.synchronize()
    assert t == t_plain == min(n1 - 1, horizon - 1)
    assert got.shape == want.shape == lead + (m, o, t) and got.dtype == dtype
    gate = _gate(ro, preds, t)
    priced = gate & preds.valid[..., None, :, :t]
    assert 0 < int(priced.sum()) < priced.numel()
    assert o == 1 or bool((gate & ~priced).any())       # invalid slots inside the gate
    # every cell Q does not price is +0.0, and the twin's is 0
    assert bool((got[~priced] == 0).all()) and not bool(torch.signbit(got[~priced]).any())
    assert bool((want[~priced] == 0).all())
    # the gate's edge: 5 m and one ulp nearer priced, one ulp farther not
    edge = priced[..., 0, 0, :]
    assert bool(edge[..., 0::3].all()) and bool(edge[..., 1::3].all())
    assert not bool(edge[..., 2::3].any())
    diff = (got - want)[priced].abs()
    assert float(diff.max()) <= ATOL[dtype], (float(diff.max()), int((diff > 0).sum()))
    assert bool(torch.isfinite(got).all())


def test_q_launches_once_per_call(cuda_device):
    ro, preds = _problem((2,), 64, 4, 31, 31, torch.float32, cuda_device)
    before = _launches()
    for n in range(1, 4):
        probability.collision_probability_fast(ro, preds, VEH)
        assert _launches() - before == n
    probability.collision_probability_fast(ro, preds, VEH, plain=True)
    assert _launches() - before == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_q_replayed_equals_eager(dtype, cuda_device):
    ro, preds = _problem((2,), 130, 16, 31, 31, dtype, cuda_device)
    eager, _ = probability.collision_probability_fast(ro, preds, VEH)
    program = C.compiled(probability.collision_probability_fast)
    before = _launches()
    for _ in range(3):
        replayed, _ = program(ro, preds, VEH)
    torch.cuda.synchronize()
    assert program.captures == 1
    assert _launches() - before == 3          # the capture's launch, added per replay
    assert torch.equal(replayed, eager)


@pytest.mark.parametrize("path", ["eager", "compiled"])
def test_q_useful_counter_equals_the_twins(path, cuda_device):
    ro, preds = _problem((3,), 200, 16, 31, 31, torch.float32, cuda_device)
    call = probability.collision_probability_fast
    if path == "compiled":
        call = C.compiled(call)
    with tracing.on():
        probability.collision_probability_fast(ro, preds, VEH, plain=True)
        twin = tracing.snapshot()
        tracing.reset()
        for _ in range(2):
            call(ro, preds, VEH)
        q = tracing.snapshot()
    useful = int(_priced(ro, preds, 30).sum())
    assert 0 < useful
    assert twin["device_counters"]["risk.quadrature.useful"] == useful
    assert q["device_counters"]["risk.quadrature.useful"] == 2 * useful
    assert q["counters"]["risk.quadrature.cells"] == 2 * 3 * 200 * 16 * 30
    # timed per replay inside a graph; eager, the profiler's span
    assert q["spans"].get("frenetix.risk.quadrature", (0.0, 0))[1] == (
        2 if path == "compiled" else 0)


def test_q_refuses_what_it_does_not_take(cuda_device):
    ro, preds = _problem((), 16, 2, 31, 31, torch.float32, cuda_device)
    half = _Rollout(*(v.half() for v in ro))
    with pytest.raises(TypeError):
        probability.collision_probability_fast(
            half, preds._replace(**{f: getattr(preds, f).half() for f in (
                "means", "covs", "orientations", "lengths")}), VEH)
    with pytest.raises(ValueError):
        probability.collision_probability_fast(ro, preds._replace(
            valid=preds.valid.cpu()), VEH)
    ro3, _ = _problem((3,), 16, 2, 31, 31, torch.float32, cuda_device)
    for lead in ((2,), ()):             # the twin takes no other axes either
        _, other = _problem(lead, 16, 2, 31, 31, torch.float32, cuda_device)
        with pytest.raises(ValueError):
            probability.collision_probability_fast(ro3, other, VEH)
