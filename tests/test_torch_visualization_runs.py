"""Plots of whole runs: the port's frames against the JAX package's, the
device run's replayed frames, and runs that cannot draw (CPU, Agg, f64).

- The host loop (one agent; two batched agents) on a short highway with
  `save_plots`, a log directory and `plot_interval` 5 writes the JAX run's
  frame file names; at every plotted step the frame's inputs (agent states,
  executed histories, prediction means, covariances and validity) equal
  the JAX run's within 1e-9 m.  One JAX run per case for the module.
- A device-resident run through `run_scenario.run_one` replays the host
  run's frame names from its fetched histories, with the agents' states
  within 1e-9 m of the host run's, and writes final.png, overview.png and
  run.gif.
- A plotted run replans exactly as its unplotted twin: the same K1 wrapper
  calls and launches, the same executed states.
- With matplotlib (or PIL for the GIF) blocked, a run that will draw fails
  with ImportError naming the package before anything runs.
"""
import os
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from frenetix_tpu_torch import run_scenario  # noqa: E402
from frenetix_tpu_torch.geometry import frenet  # noqa: E402
from frenetix_tpu_torch.sim.simulation import Simulation  # noqa: E402
from frenetix_tpu_torch.utils import config as tconfig  # noqa: E402
from frenetix_tpu_torch.utils import visualization as tvis  # noqa: E402
from tests.torch_parity import host_count, to_np  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
N_STEPS = 30
CASES = {"one_agent": {}, "two_batched": {"start_multiagent": True,
                                           "batched_device_agents": True}}


def _configure(cfg, sim_overrides):
    cfg.dtype = "float64"
    cfg.debug.activate_logging = False
    cfg.visualization.save_plots = True
    cfg.visualization.plot_interval = 5
    cfg.simulation.max_steps_factor = 1.0
    for k, v in sim_overrides.items():
        setattr(cfg.simulation, k, v)
    return cfg


def _frame_spy(module, frames):
    """A stand-in for `module.plot_scenario_at_timestep` that records the
    frame's inputs by step and then draws it."""
    real = module.plot_scenario_at_timestep

    def spy(scenario, agents, t, **kw):
        pd = kw.get("predictions")
        frames[t] = dict(
            states={a.id: np.array([*a.state.position, a.state.orientation,
                                    a.state.velocity]) for a in agents},
            records={a.id: np.array([s.position for s in a.record.states])
                     for a in agents},
            preds=None if pd is None else {k: np.array(to_np(pd[k]))
                                           for k in ("means", "covs", "valid")},
            name=os.path.basename(kw["save_path"]))
        return real(scenario, agents, t, **kw)

    return spy


def _count_k1_calls(mp, calls):
    """Count the K1 wrapper's calls from the frame conversions in `calls`."""
    real = frenet.interp_rows

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    mp.setattr(frenet, "interp_rows", counted)


def _frame_names(log_dir):
    return sorted(os.listdir(os.path.join(log_dir, "frames")))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    from frenetix_tpu.io.scenario_factory import make_highway
    from frenetix_tpu.sim.simulation import Simulation as JaxSimulation
    from frenetix_tpu.utils import visualization as jvis
    from frenetix_tpu.utils.config import FrenetixConfig as JaxConfig

    out = {}
    for case, over in CASES.items():
        log_dir = str(tmp_path_factory.mktemp(f"jax_{case}"))
        frames = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jvis, "plot_scenario_at_timestep", _frame_spy(jvis, frames))
            sim = JaxSimulation(make_highway(n_steps=N_STEPS),
                                _configure(JaxConfig(), over), log_dir=log_dir)
            res = sim.run()
        out[case] = (res, frames, _frame_names(log_dir))
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    out = {}
    for case, over in CASES.items():
        log_dir = str(tmp_path_factory.mktemp(f"torch_{case}"))
        frames = {}
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tvis, "plot_scenario_at_timestep", _frame_spy(tvis, frames))
            _count_k1_calls(mp, calls)
            launches = host_count("kernel.k1.launches")
            sim = Simulation(make_highway(n_steps=N_STEPS),
                             _configure(tconfig.FrenetixConfig(), over), CPU,
                             log_dir=log_dir)
            res = sim.run()
        out[case] = (res, frames, _frame_names(log_dir), len(calls),
                     host_count("kernel.k1.launches") - launches)
    return out


def _assert_frames_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for t in want:
        g, w = got[t], want[t]
        assert g["name"] == w["name"] == f"frame_{t:04d}.png"
        assert sorted(g["states"]) == sorted(w["states"]), (what, t)
        for aid in w["states"]:
            np.testing.assert_allclose(g["states"][aid], w["states"][aid], rtol=0,
                                       atol=1e-9, err_msg=f"{what} t={t} agent {aid}")
            assert g["records"][aid].shape == w["records"][aid].shape, (what, t, aid)
            np.testing.assert_allclose(g["records"][aid], w["records"][aid], rtol=0,
                                       atol=1e-9, err_msg=f"{what} t={t} agent {aid}")
        if w["preds"] is None:
            assert g["preds"] is None
            continue
        np.testing.assert_array_equal(g["preds"]["valid"], w["preds"]["valid"])
        for k in ("means", "covs"):
            np.testing.assert_allclose(g["preds"][k], w["preds"][k], rtol=0, atol=1e-9,
                                       err_msg=f"{what} t={t} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_host_frames_match_jax(jax_runs, port_runs, case):
    jres, jframes, jnames = jax_runs[case]
    res, frames, names, *_ = port_runs[case]
    assert res.steps == jres.steps == N_STEPS
    assert len(res.agent_status) == (2 if case == "two_batched" else 1)
    assert names == jnames == [f"frame_{t:04d}.png" for t in range(5, N_STEPS + 1, 5)]
    # one agent sees the lead vehicle; two agents predict only each other,
    # which the global prediction leaves out
    assert all(f["preds"]["valid"].any() == (case == "one_agent")
               for f in frames.values())
    _assert_frames_equal(frames, jframes, case)


def test_device_run_replays_host_frames(port_runs, tmp_path, monkeypatch):
    """`run_one` with `device_resident_sim`: the replayed frames carry the
    host run's names and agent states; final.png and overview.png."""
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    hres, hframes, hnames, *_ = port_runs["two_batched"]
    frames = {}
    monkeypatch.setattr(tvis, "plot_scenario_at_timestep", _frame_spy(tvis, frames))
    monkeypatch.setattr(run_scenario, "load_target",
                        lambda target: make_highway(n_steps=N_STEPS))
    cfg = _configure(tconfig.FrenetixConfig(), {"start_multiagent": True,
                                                "device_resident_sim": True})
    cfg.visualization.save_gif = True
    log_dir = str(tmp_path / "highway")
    res = run_scenario.run_one("highway", cfg, log_dir=log_dir, device=CPU)
    assert res.steps == hres.steps and res.agent_status == hres.agent_status
    assert _frame_names(log_dir) == hnames
    for t, want in hframes.items():
        got = frames[t]
        assert got["name"] == want["name"] and got["preds"] is None
        for aid, state in want["states"].items():
            np.testing.assert_allclose(got["states"][aid], state, rtol=0,
                                       atol=1e-9, err_msg=f"t={t} agent {aid}")
            np.testing.assert_allclose(got["records"][aid], want["records"][aid],
                                       rtol=0, atol=1e-9, err_msg=f"t={t} agent {aid}")
    for name in ("final.png", "overview.png", "run.gif"):
        assert os.path.getsize(os.path.join(log_dir, name)) > 0, name


def test_plotted_run_replans_as_its_unplotted_twin(port_runs, monkeypatch):
    from frenetix_tpu_torch.io.scenario_factory import make_highway

    res, _, _, calls, launches = port_runs["one_agent"]
    twin_calls = []
    _count_k1_calls(monkeypatch, twin_calls)
    cfg = _configure(tconfig.FrenetixConfig(), {})
    cfg.visualization.save_plots = False
    before = host_count("kernel.k1.launches")
    twin = Simulation(make_highway(n_steps=N_STEPS), cfg, CPU).run()
    assert host_count("kernel.k1.launches") - before == launches
    assert len(twin_calls) == calls > 0
    for aid, hist in twin.histories.items():
        np.testing.assert_array_equal(np.array([s.position for s in hist]),
                                      np.array([s.position for s in res.histories[aid]]))


def _block(monkeypatch, *packages):
    for name in [m for m in sys.modules if m.split(".")[0] in packages]:
        monkeypatch.delitem(sys.modules, name)
    for p in packages:
        monkeypatch.setitem(sys.modules, p, None)


@pytest.mark.parametrize("flags, blocked", [
    (["--plot"], "matplotlib"),
    (["--device-sim", "--plot"], "matplotlib"),
    (["--plot", "--gif"], "PIL"),
], ids=["plot", "device_sim", "gif_without_pil"])
def test_cli_without_the_package_fails_before_the_run(tmp_path, monkeypatch, capsys,
                                                      flags, blocked):
    import csv

    _block(monkeypatch, blocked)
    loads = []
    monkeypatch.setattr(run_scenario, "load_target", lambda t: loads.append(t))
    before = host_count("kernel.k1.launches")
    logs = tmp_path / "logs"
    rc = run_scenario.main(["highway", "--device", "cpu", "--logs", str(logs), *flags])
    assert rc == 1 and not loads and host_count("kernel.k1.launches") == before
    rows = list(csv.reader(open(logs / "log_failures.csv"), delimiter=";"))
    assert len(rows) == 1 and rows[0][0] == "highway"
    assert rows[0][1].startswith("ImportError") and blocked in rows[0][1]
    assert not (logs / "highway").exists()
    assert "status=" not in capsys.readouterr().out
