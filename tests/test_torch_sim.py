"""The port's single-agent simulation, config, import closure and card tests.

- Simulation parity: the port's `Simulation` against the JAX `Simulation` at
  float64 on the highway and overtake families: statuses and step counts
  equal, every executed position within 1e-9 m.
- Config defaults equal to the JAX package's, field by field; the occlusion
  and behavior sections carry every field of the JAX package's.
- Import closure: every module of the port, its run_scenario and chip_smoke
  import with a `sys.meta_path` finder that raises on `jax`, `jaxlib`,
  `frenetix_tpu` (the exact name; `frenetix_tpu_torch` still imports),
  `pandas`, `yaml` and `matplotlib` (the machine with the card has none of
  them), and the CLI path (`run_scenario.main` with `--evaluate` and the
  logs) runs to its end under the same finder.
- Default device: `Simulation(scenario, config)` without a device uses the
  CUDA device and raises where there is none.
- K1 on the card (marker `cuda`; they skip without a CUDA device).  This file
  imports JAX only inside the parity tests, so on a machine without JAX the
  card tests run with
  `python -m pytest tests/test_torch_sim.py -m cuda --noconftest`.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.ops import _kernels, table_interp
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ----------------------------------------------------------------- simulation


@pytest.mark.parametrize("family", ["highway", "overtake"])
def test_simulation_matches_jax(family):
    from frenetix_tpu.io import scenario_factory
    from frenetix_tpu.sim import Simulation as JaxSimulation
    from frenetix_tpu.utils.config import load_config as jax_load_config

    make = getattr(scenario_factory, f"make_{family}")
    jcfg = jax_load_config()
    jcfg.dtype = "float64"
    tcfg = tconfig.load_config()
    tcfg.dtype = "float64"
    jres = JaxSimulation(make(), jcfg).run()
    before = table_interp.LAUNCHES
    tres = Simulation(make(), tcfg, torch.device("cpu")).run()
    assert table_interp.LAUNCHES == before       # the CPU path uses the plain twin

    assert tres.steps == jres.steps
    assert ({k: v.name for k, v in tres.agent_status.items()}
            == {k: v.name for k, v in jres.agent_status.items()})
    assert tres.success
    assert len(tres.planning_times) == len(jres.planning_times)
    for aid, hist in jres.histories.items():
        thist = tres.histories[aid]
        assert len(thist) == len(hist)
        np.testing.assert_allclose(np.array([s.position for s in thist]),
                                   np.array([s.position for s in hist]), atol=1e-9)
        np.testing.assert_allclose([s.velocity for s in thist],
                                   [s.velocity for s in hist], atol=1e-9)


def test_run_scenario_cli_on_cpu(capsys, tmp_path):
    from frenetix_tpu_torch.run_scenario import main

    assert main(["highway", "--device", "cpu", "--logs", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "SYN_Highway-1 agent=60000 status=COMPLETED_SUCCESS" in out


def test_run_scenario_cuda_without_cuda_raises():
    from frenetix_tpu_torch.run_scenario import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


@pytest.mark.parametrize("override", [
    {"simulation": {"sharded_device_agents": True}},
    {"simulation": {"start_multiagent": True, "sharded_device_agents": True}},
    {"behavior": {"use_behavior_planner": True}, "prediction": {"mode": "walenet"}},
    {"simulation": {"device_resident_sim": True, "sharded_device_agents": True},
     "behavior": {"use_behavior_planner": True}},
    {"simulation": {"device_resident_sim": True}, "prediction": {"mode": "walenet"}},
    {"prediction": {"mode": "walenet"}},
])
def test_features_outside_the_slice_raise(override):
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    cfg = tconfig.load_config(overrides=override, strict_overrides=True)
    with pytest.raises(NotImplementedError, match="slice"):
        Simulation(make_highway(), cfg, torch.device("cpu"))


@pytest.mark.parametrize("override", [
    {"planning": {"emergency_mode": "min_risk"}},
    {"debug": {"log_risk": True}},
    {"simulation": {"start_multiagent": True}},
    {"simulation": {"start_multiagent": True, "batched_device_agents": True}},
    {"cost_weights": {"responsibility": 0.5}},
    {"occlusion": {"use_occlusion_module": True}},
    {"prediction": {"calc_occlusions": True}},
    {"occlusion": {"use_occlusion_module": True},
     "external_cost_weights": {"occ_um": 2.0, "occ_ve": 0.5}},
    {"simulation": {"device_resident_sim": True}},
    {"simulation": {"start_multiagent": True, "device_resident_sim": True}},
    {"behavior": {"use_behavior_planner": True}},
    {"behavior": {"use_behavior_planner": True},
     "simulation": {"start_multiagent": True, "batched_device_agents": True}},
    {"behavior": {"use_behavior_planner": True, "device_fsm": "hybrid"},
     "simulation": {"start_multiagent": True, "device_resident_sim": True}},
])
def test_features_of_this_slice_construct(override):
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    cfg = tconfig.load_config(overrides=override, strict_overrides=True)
    sim = Simulation(make_highway(), cfg, torch.device("cpu"))
    assert len(sim.agents) == (2 if cfg.simulation.start_multiagent else 1)


def test_simulation_defaults_to_the_card_and_raises_without_one():
    import frenetix_tpu_torch
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    if torch.cuda.is_available():
        assert Simulation(make_highway()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        frenetix_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA device"):
        Simulation(make_highway(), tconfig.load_config())


# --------------------------------------------------------------------- config


def test_config_defaults_match_jax():
    import dataclasses

    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    jcfg, tcfg = JaxConfig(), tconfig.FrenetixConfig()
    for section in ("planning", "debug", "simulation", "prediction", "behavior",
                    "occlusion", "evaluation", "visualization"):
        tsec = getattr(tcfg, section)
        for f in dataclasses.fields(tsec):
            assert getattr(tsec, f.name) == getattr(getattr(jcfg, section), f.name), \
                f"{section}.{f.name}"
    # every section is carried whole
    for section, n_fields in (("occlusion", 14), ("behavior", 23), ("debug", 7),
                              ("simulation", 15), ("evaluation", 7),
                              ("visualization", 11)):
        assert ({f.name for f in dataclasses.fields(getattr(tcfg, section))}
                == {f.name for f in dataclasses.fields(getattr(jcfg, section))}), section
        assert len(dataclasses.fields(getattr(tcfg, section))) == n_fields, section
    assert tcfg.external_cost_weights == jcfg.external_cost_weights
    assert tcfg.planning.n_steps == jcfg.planning.n_steps
    assert tcfg.vehicle._fields == jcfg.vehicle._fields
    assert tuple(tcfg.vehicle) == tuple(jcfg.vehicle)
    assert tcfg.cost_weights == jcfg.cost_weights
    assert tcfg.dtype == jcfg.dtype


def test_load_config_overrides_and_yaml_dir(tmp_path):
    (tmp_path / "planning.yaml").write_text("replanning_frequency: 1\nunknown_key: 3\n")
    (tmp_path / "cost.yaml").write_text("cost_weights:\n  prediction: 0.7\n")
    cfg = tconfig.load_config(str(tmp_path), overrides={"vehicle": {"length": 5.0}})
    assert cfg.planning.replanning_frequency == 1
    assert cfg.cost_weights["prediction"] == 0.7
    assert cfg.vehicle.length == 5.0
    with pytest.raises(ValueError, match="unknown"):
        tconfig.load_config(overrides={"planning": {"nope": 1}}, strict_overrides=True)


# ------------------------------------------------------------- import closure


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "frenetix_tpu", "pandas", "yaml", "matplotlib")
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]

class BlockReference:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, BlockReference())
import frenetix_tpu_torch
names = [m.name for m in pkgutil.walk_packages(frenetix_tpu_torch.__path__,
                                               "frenetix_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for expected in ("geometry.refpath", "geometry.corridor", "ops.sampling",
                 "io.commonroad", "io.scenario_factory", "parallel.mesh",
                 "parallel.batched_sim", "parallel.device_sim", "risk.probability",
                 "risk.harm", "risk.costs", "risk.reachable_set", "sim.visible_area",
                 "sim.sensor_model", "occlusion", "occlusion.occlusion_module",
                 "behavior", "behavior.frame", "behavior.static_route",
                 "behavior.velocity_planner", "behavior.path_planner", "behavior.fsm",
                 "behavior.behavior_module", "behavior.device_fsm", "sim.world_view",
                 "sim.planner_interfaces", "run_scenario", "workloads"):
    assert "frenetix_tpu_torch." + expected in names, expected
import chip_smoke
import os
from frenetix_tpu_torch.run_scenario import main
logs = sys.argv[1]
rc = main(["highway", "--device", "cpu", "--evaluate", "--logs", logs,
           "--set", "planning.sampling_min=1", "--set", "planning.sampling_max=2"])
assert rc == 0, rc
for rel in ("messages.log", "score_overview.csv", "highway/simulation.db",
            "highway/60000/trajectories.db", "highway/60000/logs.csv",
            "highway/solution_60000.xml"):
    assert os.path.exists(os.path.join(logs, rel)), rel
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
try:
    import frenetix_tpu
except ImportError:
    print("imported without jax and without frenetix_tpu")
"""


def test_port_and_chip_smoke_import_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(tmp_path / "logs")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported without jax and without frenetix_tpu" in proc.stdout


def test_kernel_build_without_nvcc_raises():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load_library("table_interp")


# ------------------------------------------------------------ K1 on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 255, 1_079_296, 1_000_003])
def test_k1_kernel_bitwise_equals_plain_twin(cuda_device, dtype, p):
    rng = np.random.default_rng(p)
    table = torch.as_tensor(rng.normal(size=(868, 7)) * 50.0, dtype=dtype,
                            device=cuda_device)
    gidx = torch.as_tensor(rng.integers(0, 867, p), dtype=torch.int32,
                           device=cuda_device)
    lam = torch.as_tensor(rng.uniform(-0.5, 1.5, p), dtype=dtype, device=cuda_device)
    before = table_interp.LAUNCHES
    got = table_interp.interp_rows(table, gidx, lam)
    assert table_interp.LAUNCHES == before + 1
    want = table_interp.interp_rows_plain(table, gidx, lam)
    torch.cuda.synchronize()
    assert got.shape == (7, p) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k1_wrapper_rejects_bad_inputs(cuda_device):
    table = torch.zeros((10, 3), device=cuda_device)
    gidx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    lam = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):
        table_interp.interp_rows(table, gidx.long(), lam)
    with pytest.raises(TypeError):
        table_interp.interp_rows(table, gidx, lam.double())
    with pytest.raises(ValueError):
        table_interp.interp_rows(table, gidx, lam.cpu())
    with pytest.raises(ValueError):
        table_interp.interp_rows(table.T, gidx, lam)


@pytest.mark.cuda
def test_dense_cycle_on_card_matches_cpu_float64(cuda_device):
    from frenetix_tpu_torch.planner.core import evaluate_cycle
    from frenetix_tpu_torch.workloads import dense_cycle_problem

    def run(device, dtype):
        m, k, c, dt, n, _ = dense_cycle_problem(device, dtype, density=3, bucket=256)
        return evaluate_cycle(m, k, c, dt=dt, n_steps=n, low_vel_mode=False), k

    before = table_interp.LAUNCHES
    res, mask = run(cuda_device, torch.float32)
    assert table_interp.LAUNCHES > before
    ref, _ = run(torch.device("cpu"), torch.float64)
    assert bool(res.found) and bool(ref.found)
    np.testing.assert_array_equal(res.histogram.cpu().numpy(), ref.histogram.numpy())
    best, best64 = int(res.best_idx), int(ref.best_idx)
    if best != best64:      # accepted only as a float32 round-off tie
        cost = ref.cost.numpy()
        assert abs(cost[best] - cost[best64]) <= 4 * np.spacing(np.float32(cost[best64]))
    m = mask.cpu().numpy()
    np.testing.assert_allclose(res.rollout.x.cpu().numpy()[m], ref.rollout.x.numpy()[m],
                               atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_cycle_on_card_is_one_launch_and_equals_sequential(cuda_device, dtype):
    """On the card the batched call launches K1 exactly once, on the stacked
    table, and selects per agent what the agent's own cycle selects there
    (bitwise equal costs: same kernel, same elementwise order)."""
    from frenetix_tpu_torch import workloads
    from frenetix_tpu_torch.parallel.mesh import batched_full_cycle
    from frenetix_tpu_torch.planner.core import evaluate_cycle

    n_agents = 8
    matrices, masks, ctx, ctxs, dt, n = workloads.stacked_cycle_problem(
        n_agents, cuda_device, dtype, m_bucket=1024, spread=12.0, ragged=True)
    fn = batched_full_cycle(dt=dt, n_steps=n)
    table_interp.reset_launches()
    out = fn(matrices, masks, ctx)
    torch.cuda.synchronize()
    assert table_interp.LAUNCHES == 1
    res = evaluate_cycle(matrices, masks, ctx, dt=dt, n_steps=n, low_vel_mode=False)
    for a in range(n_agents):
        seq = evaluate_cycle(matrices[a], masks[a], ctxs[a], dt=dt, n_steps=n,
                             low_vel_mode=False)
        assert int(out["best"][a]) == int(seq.best_idx)
        assert torch.equal(res.cost[a], seq.cost)
    assert table_interp.LAUNCHES == 2 + n_agents
