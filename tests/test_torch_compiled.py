"""Compiled programs (`utils.compiled`, the port's `jax.jit`) on the CPU.

- (a) keying: one entry per distinct (static values, tensor shapes, dtypes
  and devices, non-tensor leaf values), and no more;
- (b) the port makes as many programs as the JAX package: on the host
  highway in float64 its `evaluate_cycle` entries equal the distinct
  signatures of the JAX package's `evaluate_cycle` calls (recorded as
  `utils.parting.CycleTrace` patches the name), and on the batched convoy
  its stepper program's entries equal the distinct signatures of the JAX
  stepper's jitted step;
- (c) outputs belong to the caller: a later call with the same key leaves
  an earlier result as it was;
- (d) a compiled callable called inside another compiled body makes no
  entry of its own (it is inlined);
- (e) `disable_compiled()` runs eagerly and makes no entry;
- (f) a host highway, a batched convoy, a min_risk run, a responsibility run,
  the gated blind spot and a Wale-Net highway through the compiled paths
  equal their `disable_compiled()` twins bitwise, and every program of the
  path made an entry.

A capture is a CUDA-only step; the card's cases carry the `cuda` marker
(the file imports JAX inside the tests that need it, so that the card's
machine, which has none, can run them).
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.models import walenet as twalenet
from frenetix_tpu_torch.planner import core as tcore
from frenetix_tpu_torch.planner import reactive as treactive
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import compiled as C
from frenetix_tpu_torch.utils.config import FrenetixConfig

from torch_parity import host_count

CPU = torch.device("cpu")


def _parity():
    """The CPU tests' helpers (`tests.torch_parity`), imported where used:
    the card's machine collects this file for its `cuda` cases without
    them."""
    from tests import torch_parity

    return torch_parity

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_caches():
    C.clear_all()
    yield
    C.clear_all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _leaves(tree):
    leaves = []
    C._flatten(tree, leaves)
    return leaves


def _program():
    calls = []

    @C.compiled(static=("scale",))
    def program(x, pair, *, scale, offset=0.5):
        calls.append(1)
        return {"y": x * scale + pair[0].sum() + offset, "n": (pair[1] > 0).sum()}

    return program, calls


# ------------------------------------------------------------------ (a)


def test_one_entry_per_signature_and_no_more():
    program, calls = _program()
    x = torch.arange(6.0).reshape(2, 3)
    pair = (torch.ones(3), torch.tensor([1, -1, 2]))
    for _ in range(3):
        program(x, pair, scale=2.0)
    program(x + 1, (pair[0] * 2, pair[1]), scale=2.0)     # new values: same key
    program(x, pair, scale=2.0, offset=0.5)                # default spelled out
    assert len(program.entries) == 1
    program(x, pair, scale=3.0)                            # static value
    program(x.double(), pair, scale=2.0)                   # dtype
    program(torch.zeros(3, 3), pair, scale=2.0)            # shape
    program(x, pair, scale=2.0, offset=1.5)                # non-tensor leaf value
    program(x, [pair[0], pair[1]], scale=2.0)              # structure: list
    assert len(program.entries) == 6
    for _ in range(2):
        program(x, pair, scale=3.0)
        program(x, pair, scale=2.0, offset=1.5)
    assert len(program.entries) == 6 and program.captures == 6
    assert C.stats()[f"{program.__module__}.{program.__qualname__}"][:2] == (6, 6)


def test_entry_cache_keeps_the_latest_entries():
    program, _ = _program()
    pair = (torch.ones(3), torch.tensor([1, -1, 2]))
    for n in range(C.MAX_ENTRIES + 3):
        program(torch.zeros(n + 1), pair, scale=1.0)
    assert len(program.entries) == C.MAX_ENTRIES
    shapes = [key[2][0][0] for key in program.entries]
    assert shapes[0] == (4,) and shapes[-1] == (C.MAX_ENTRIES + 3,)


def test_broadcast_and_strided_inputs_keep_their_layout():
    @C.compiled
    def program(a, b):
        return (a * 2 + b).sum(dim=-1)

    a = torch.arange(3.0).reshape(1, 3).expand(4, 3)      # a stride-0 axis
    b = torch.arange(24.0).reshape(4, 6)[:, ::2]          # a strided view
    got = program(a, b)
    with C.disable_compiled():
        want = program(a, b)
    assert torch.equal(got, want) and len(program.entries) == 1
    assert program(a.contiguous(), b.contiguous()).equal(want)
    assert len(program.entries) == 2                      # strides key the entry


def test_a_tensor_as_static_argument_raises():
    program, _ = _program()
    with pytest.raises(TypeError, match="static argument 'scale' holds a tensor"):
        program(torch.ones(2), (torch.ones(1), torch.ones(1)), scale=torch.ones(1))


def test_unhashable_leaf_raises():
    program, _ = _program()
    with pytest.raises(TypeError, match="neither a tensor nor hashable"):
        program(torch.ones(2), (torch.ones(1), torch.ones(1)), scale=1.0,
                offset=np.ones(2))


# ------------------------------------------------------------------ (c)


def test_outputs_belong_to_the_caller():
    program, _ = _program()
    pair = (torch.ones(3), torch.tensor([1, -1, 2]))
    first = program(torch.arange(3.0), pair, scale=2.0)
    kept = {k: v.clone() for k, v in first.items()}
    second = program(torch.arange(3.0) + 10, (pair[0] * 5, -pair[1]), scale=2.0)
    assert len(program.entries) == 1
    for k in kept:
        assert torch.equal(first[k], kept[k])
        assert first[k].data_ptr() != second[k].data_ptr()
    assert not torch.equal(first["y"], second["y"])


def test_an_output_that_is_an_input_is_copied_too():
    @C.compiled
    def identity(x):
        return x

    x = torch.arange(4.0)
    y = identity(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    x += 1
    z = identity(x)
    assert torch.equal(y, torch.arange(4.0)) and torch.equal(z, x)


def test_cycle_result_of_an_earlier_call_survives_a_later_call():
    from frenetix_tpu_torch.workloads import stacked_cycle_problem

    matrices, masks, _, ctxs, dt, n = stacked_cycle_problem(
        2, CPU, torch.float64, m_bucket=64)
    first = tcore.evaluate_cycle(matrices[0], masks[0], ctxs[0], dt=dt, n_steps=n,
                                 low_vel_mode=False)
    kept = [t.clone() for t in _leaves(first)]
    second = tcore.evaluate_cycle(matrices[1], masks[1], ctxs[1], dt=dt, n_steps=n,
                                  low_vel_mode=False)
    assert len(tcore.evaluate_cycle.entries) == 1
    for a, b in zip(_leaves(first), kept):
        assert torch.equal(a, b)
    assert not torch.equal(first.rollout.x, second.rollout.x)


# ------------------------------------------------------------------ (d), (e)


def test_a_compiled_callable_inside_a_compiled_body_is_inlined():
    inner, _ = _program()

    @C.compiled
    def outer(x, pair):
        return inner(x, pair, scale=2.0)["y"] + 1

    pair = (torch.ones(3), torch.tensor([1, -1, 2]))
    got = outer(torch.arange(3.0), pair)
    assert len(outer.entries) == 1 and len(inner.entries) == 0
    assert torch.equal(got, inner(torch.arange(3.0), pair, scale=2.0)["y"] + 1)
    assert len(inner.entries) == 1


def test_disable_compiled_runs_eagerly_and_makes_no_entry():
    program, calls = _program()
    pair = (torch.ones(3), torch.tensor([1, -1, 2]))
    captures = C.CAPTURES
    with C.disable_compiled():
        out = program(torch.arange(3.0), pair, scale=2.0)
        with C.disable_compiled():
            pass
        program(torch.arange(3.0), pair, scale=2.0)       # still disabled
    assert len(program.entries) == 0 and C.CAPTURES == captures and len(calls) == 2
    assert torch.equal(out["y"], program(torch.arange(3.0), pair, scale=2.0)["y"])
    assert len(program.entries) == 1 and C.CAPTURES == captures + 1


# ------------------------------------------------------------------ (b)


def _jax_signature(args, kwargs, static):
    """What keys a JAX jit entry: the static values, the tree structure, and
    each leaf's shape and dtype (a Python scalar by its type)."""
    import jax

    dynamic = {k: v for k, v in kwargs.items() if k not in static}
    leaves, treedef = jax.tree_util.tree_flatten((args, dynamic))
    specs = tuple((np.shape(x), np.asarray(x).dtype.str)
                  if hasattr(x, "shape") else type(x) for x in leaves)
    return tuple(sorted((k, kwargs[k]) for k in static if k in kwargs)), treedef, specs


_J1_STATIC = ("dt", "n_steps", "low_vel_mode", "quintic_lon", "check_boundary",
              "table_window", "compensated_sum")


def test_host_highway_makes_as_many_cycle_programs_as_jax(monkeypatch):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.planner import reactive as jreactive
    from frenetix_tpu.sim.simulation import Simulation as JSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    seen = set()
    jeval = jreactive.evaluate_cycle

    def recording(matrix, mask, ctx, **kw):
        seen.add(_jax_signature((matrix, mask, ctx), kw, _J1_STATIC))
        return jeval(matrix, mask, ctx, **kw)

    monkeypatch.setattr(jreactive, "evaluate_cycle", recording)
    captures = tcore.evaluate_cycle.captures
    # a standing vehicle 14 m ahead: cycles that find nothing try sampling
    # levels 1 and 2 (each of its own M) before the stopping fallback
    scenario = dict(lead_v=0.0, lead_gap=14.0, n_steps=30)

    def config(cls):
        cfg = cls(dtype="float64")
        cfg.planning.sampling_min, cfg.planning.sampling_max = 1, 3
        return cfg

    jsim = JSimulation(jfactory.make_highway(**scenario), config(JConfig))
    jres = jsim.run()
    tsim = Simulation(tfactory.make_highway(**scenario), config(FrenetixConfig), CPU)
    tres = tsim.run()
    assert tres.steps == jres.steps
    assert len(seen) >= 2                     # the levels differ in M
    assert len(tcore.evaluate_cycle.entries) == len(seen)
    assert tcore.evaluate_cycle.captures - captures == len(seen)


def test_batched_convoy_makes_as_many_stepper_programs_as_jax(monkeypatch):
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.parallel import batched_sim as jbatched
    from frenetix_tpu.sim.simulation import Simulation as JSimulation
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    seen = set()
    build = jbatched.BatchedAgentStepper._build

    def recording_build(self):
        step = build(self)

        def recorded(*args):
            seen.add(_jax_signature(args, {}, ()))
            return step(*args)

        return recorded

    monkeypatch.setattr(jbatched.BatchedAgentStepper, "_build", recording_build)

    def config(cls):
        cfg = _parity().coarse_sampling(cls(dtype="float64"))
        cfg.simulation.start_multiagent = True
        cfg.simulation.batched_device_agents = True
        return cfg

    jsim = JSimulation(jfactory.make_convoy(), config(JConfig))
    jsim.max_steps = 9
    jsim.run()
    tsim = Simulation(tfactory.make_convoy(), config(FrenetixConfig), CPU)
    tsim.max_steps = 9
    tsim.run()
    program = tsim._batched_stepper._cycle
    assert isinstance(program, C.Compiled) and seen
    assert len(program.entries) == len(seen)


# ------------------------------------------------------------------ (f)


def _equal_runs(make_sim, programs):
    """The run of `make_sim()` through the compiled paths equals its eager
    twin bitwise; every program in `programs` made an entry."""
    with C.disable_compiled():
        sim = make_sim()
        eager = sim.run()
        eager_states = _parity().agent_states(sim)
    assert all(len(p.entries) == 0 for p in programs)
    sim = make_sim()
    got = sim.run()
    assert got.steps == eager.steps and got.agent_status == eager.agent_status
    states = _parity().agent_states(sim)
    assert states.keys() == eager_states.keys()
    for aid, rows in eager_states.items():
        assert np.array_equal(states[aid], rows), aid
    for p in programs:
        assert p.entries, p.__qualname__
    return sim, got


def _cfg(**kw):
    cfg = FrenetixConfig(dtype="float64")
    for k, v in kw.items():
        section, _, name = k.partition("__")
        setattr(getattr(cfg, section), name, v)
    return cfg


def test_host_highway_equals_its_eager_twin():
    _equal_runs(lambda: Simulation(tfactory.make_highway(n_steps=60), _cfg(), CPU),
                [tcore.evaluate_cycle, treactive._replan_pack])


def test_batched_convoy_equals_its_eager_twin():
    def make():
        cfg = _parity().coarse_sampling(_cfg(simulation__start_multiagent=True,
                                             simulation__batched_device_agents=True))
        sim = Simulation(tfactory.make_convoy(), cfg, CPU)
        sim.max_steps = 12
        return sim

    sim, _ = _equal_runs(make, [])
    assert sim._batched_stepper._cycle.entries


def test_min_risk_run_equals_its_eager_twin():
    modes = []
    plan = treactive.ReactivePlanner.plan

    def make():
        cfg = _parity().coarse_sampling(_cfg(planning__emergency_mode="min_risk",
                                             debug__log_risk=True))
        cfg.prediction.max_obstacles = 2
        sim = Simulation(tfactory.make_highway(lead_v=0.0, lead_gap=14.0, n_steps=30),
                         cfg, CPU)
        sim.max_steps = 6
        return sim

    def recording(self, x0, x_cl):
        out = plan(self, x0, x_cl)
        modes.append(None if out is None else (out.mode, out.ego_risk))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treactive.ReactivePlanner, "plan", recording)
        _equal_runs(make, [treactive._risk_program, treactive._select_rows])
    half = len(modes) // 2
    assert modes[:half] == modes[half:]
    assert any(m and m[0] == "min_risk" for m in modes)


def test_responsibility_run_equals_its_eager_twin():
    def make():
        cfg = _parity().coarse_sampling(_cfg(simulation__start_multiagent=True))
        cfg.cost_weights["responsibility"] = 0.2
        cfg.prediction.max_obstacles = 4
        sim = Simulation(tfactory.make_highway(n_steps=40), cfg, CPU)
        sim.max_steps = 6
        return sim

    _equal_runs(make, [treactive._responsibility])


def test_gated_blind_spot_equals_its_eager_twin():
    from frenetix_tpu_torch.io import commonroad

    def make():
        cfg = _parity().coarse_sampling(_cfg(simulation__start_multiagent=True))
        cfg.prediction.max_obstacles = 4
        cfg.occlusion.use_occlusion_module = True
        cfg.occlusion.harm_threshold = 0.02
        cfg.external_cost_weights["occ_um"] = 2.0
        cfg.external_cost_weights["occ_ve"] = 0.5
        cfg.prediction.calc_occlusions = True
        sim = Simulation(_parity().blind_spot(tfactory, commonroad, n_steps=60), cfg, CPU)
        sim.max_steps = 6
        return sim

    _equal_runs(make, [treactive._occlusion_pack])


def test_walenet_highway_equals_its_eager_twin(tmp_path, monkeypatch):
    from frenetix_tpu_torch.workloads import write_synthetic_walenet_onnx

    path = write_synthetic_walenet_onnx(
        str(tmp_path / "wale.onnx"), 0, conv1=4, conv2=3, embed=4, enc=6, nbr_feat=5,
        scene_feat=3, dec=7)
    monkeypatch.setattr(twalenet, "WALENET_ONNX_PATH", path)
    monkeypatch.setattr(twalenet, "_WALENET_CACHE", {})
    monkeypatch.setattr(twalenet.WaleNet, "_net_cache", {})

    def make():
        cfg = _parity().coarse_sampling(_cfg(prediction__mode="walenet"))
        sim = Simulation(tfactory.make_highway(n_steps=40), cfg, CPU)
        sim.max_steps = 6
        return sim

    _equal_runs(make, [twalenet._net_program])


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_compiled_cycle_on_the_card_equals_eager_and_counts_k1(cuda_device):
    from frenetix_tpu_torch.workloads import stacked_cycle_problem

    matrices, masks, _, ctxs, dt, n = stacked_cycle_problem(
        2, cuda_device, torch.float32, m_bucket=256)
    call = functools.partial(tcore.evaluate_cycle, dt=dt, n_steps=n, low_vel_mode=False)
    with C.disable_compiled():
        k1 = host_count("kernel.k1.launches")
        want = [call(matrices[a], masks[a], ctxs[a]) for a in range(2)]
        eager_k1 = host_count("kernel.k1.launches") - k1
    k1 = host_count("kernel.k1.launches")
    got = [call(matrices[a], masks[a], ctxs[a]) for a in range(2)]
    # both agents' cycles share one signature: one capture, two replays
    assert host_count("kernel.k1.launches") - k1 == eager_k1 == 2
    assert len(tcore.evaluate_cycle.entries) == 1
    for g, w in zip(got, want):
        for a, b in zip(_leaves(g), _leaves(w)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_captures_again_after_every_entry_was_dropped(cuda_device):
    """The shared graph pool is retired with its last graph; the next capture
    takes a new one."""
    program, _ = _program()
    pair = (torch.ones(3, device=cuda_device), torch.ones(3, device=cuda_device))
    first = program(torch.arange(3.0, device=cuda_device), pair, scale=2.0)
    C.clear_all()
    again = program(torch.arange(3.0, device=cuda_device), pair, scale=2.0)
    assert torch.equal(first["y"], again["y"]) and len(program.entries) == 1


@pytest.mark.cuda
def test_a_host_sync_in_a_compiled_body_raises_on_the_card(cuda_device):
    @C.compiled
    def syncing(x):
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError):
        syncing(torch.ones(4, device=cuda_device))
    assert not syncing.entries
    with contextlib.suppress(Exception):
        torch.cuda.synchronize()
