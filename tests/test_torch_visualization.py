"""Plots of the PyTorch port against the JAX package's, on the CPU (Agg).

The same NumPy inputs, made from a seed, go to each of the nine public
plotting functions of `frenetix_tpu/utils/visualization.py` and
`frenetix_tpu/risk/visualization.py` as JAX arrays and to their copies in
`frenetix_tpu_torch` as float64 torch tensors; the decoded PNGs must be
equal pixel for pixel (no tolerance), and `make_gif` must give equal frames.
Also: live mode reuses one figure, and `fetch`'s one-copy buffer splits
back exactly.
"""
import csv
import types

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image, ImageSequence  # noqa: E402

from frenetix_tpu.risk import visualization as jrisk_vis  # noqa: E402
from frenetix_tpu.utils import visualization as jvis  # noqa: E402
from frenetix_tpu_torch.risk import visualization as trisk_vis  # noqa: E402
from frenetix_tpu_torch.utils import visualization as tvis  # noqa: E402
from tests.torch_parity import Arrays, jnp_array, random_risks, t64  # noqa: E402

torch.set_num_threads(1)

M, N1 = 48, 31


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def assert_same_png(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape, (pa.shape, pb.shape)
    assert np.array_equal(pa, pb), f"{int((pa != pb).any(-1).sum())} pixels differ"


def _scenarios():
    from frenetix_tpu.io.scenario_factory import make_highway as jmake
    from frenetix_tpu_torch.io.scenario_factory import make_highway as tmake

    return jmake(n_steps=40), tmake(n_steps=40)


def _agents(rng):
    """Two stand-in agents (plain NumPy, handed to both packages): state,
    executed history, goal polygon and reference path."""
    agents = []
    for k, aid in enumerate((60000, 7)):
        start = np.array([10.0 + 25.0 * k, 1.75 + 0.3 * k])
        hist = start + np.cumsum(rng.normal([1.2, 0.0], [0.05, 0.02], (12, 2)), axis=0)
        states = [types.SimpleNamespace(position=p, orientation=0.02 * i, velocity=12.0)
                  for i, p in enumerate(hist)]
        goal = types.SimpleNamespace(position_shape=np.array(
            [[90.0, 0.0], [110.0, 0.0], [110.0, 3.5], [90.0, 3.5]]) + [5.0 * k, 0.0])
        xs = np.linspace(-20.0, 200.0, 80)
        agents.append(types.SimpleNamespace(
            id=aid, state=states[-1], record=types.SimpleNamespace(states=states),
            problem=types.SimpleNamespace(goals=[goal, types.SimpleNamespace()]),
            planner=types.SimpleNamespace(ref_np=types.SimpleNamespace(
                xy=np.stack([xs, 1.75 + 0.01 * xs], axis=1)))))
    return agents


def _fan(rng):
    """A candidate fan around the first agent: rollout x/y, cost (the
    rejected ones at 1e15), selectable, best_idx."""
    t = np.linspace(0.0, 3.0, N1)
    x = 25.0 + np.outer(rng.uniform(8.0, 14.0, M), t)
    y = 1.75 + np.outer(rng.uniform(-3.0, 3.0, M), t / 3.0)
    cost = rng.uniform(1.0, 50.0, M)
    sel = rng.uniform(size=M) < 0.7
    cost[~sel] = 1e15
    best = int(np.argmin(np.where(sel, cost, np.inf)))
    return dict(x=x, y=y, cost=cost, selectable=sel, best_idx=np.int32(best))


def _cycle_result(arrays, xp):
    """A stand-in CycleResult of `_fan`'s arrays, each passed through `xp`
    (`jnp_array`, or `t64` for the port; best_idx stays int32)."""
    res = Arrays(xp, cost=arrays["cost"], selectable=arrays["selectable"])
    res.rollout = Arrays(xp, x=arrays["x"], y=arrays["y"])
    res.best_idx = (jnp_array(arrays["best_idx"]) if xp is jnp_array
                    else torch.tensor(int(arrays["best_idx"]), dtype=torch.int32))
    return res


def _predictions(rng):
    o, t = 3, 30
    means = np.cumsum(rng.normal([1.0, 0.0], [0.1, 0.05], (o, t, 2)), axis=1) + [[40.0, 5.25]]
    covs = np.tile(np.eye(2), (o, t, 1, 1)) * rng.uniform(0.2, 1.0, (o, t, 1, 1))
    covs[..., 0, 1] = covs[..., 1, 0] = 0.1
    valid = np.ones((o, t), bool)
    valid[1, 17:] = False
    valid[2] = False
    return dict(means=means, covs=covs, valid=valid)


class _Visible:
    def polygon(self):
        return np.array([[0.0, -5.0], [80.0, -10.0], [80.0, 15.0], [0.0, 10.0]])


@pytest.mark.parametrize("variant", ["full", "plain"])
def test_plot_scenario_at_timestep_same_pixels(tmp_path, variant):
    rng = np.random.default_rng(11)
    jsc, tsc = _scenarios()
    agents = _agents(rng)
    arrays = _fan(rng)
    preds = _predictions(rng)
    mask = rng.uniform(size=M) < 0.9
    paths = {}
    for name, mod, sc, xp in (("jax", jvis, jsc, jnp_array), ("torch", tvis, tsc, t64)):
        kw = dict(save_path=str(tmp_path / name / "frame_0005.png"), window=50.0)
        if variant == "full":
            kw.update(cycle_result=_cycle_result(arrays, xp), matrix_mask=xp(mask),
                      predictions={k: xp(v) for k, v in preds.items()},
                      visible_area=_Visible(), draw_icons=True)
        else:
            kw.update(show_labels=False, draw_planning_problem=False, show_ref=False,
                      veh_length=4.0, veh_width=1.8)
        paths[name] = mod.plot_scenario_at_timestep(sc, agents, 5, **kw)
    assert_same_png(paths["jax"], paths["torch"])


def _result(rng, n_agents):
    histories = {}
    for k in range(n_agents):
        xy = np.array([12.0 + 20.0 * k, 1.75 + 3.5 * (k % 2)]) + np.cumsum(
            rng.normal([1.1, 0.0], [0.1, 0.03], (40, 2)), axis=0)
        histories[100 * k + 7] = [types.SimpleNamespace(position=p, velocity=v)
                                  for p, v in zip(xy, rng.uniform(5.0, 15.0, 40))]
    status = types.SimpleNamespace(name="COMPLETED_SUCCESS")
    return types.SimpleNamespace(
        scenario_id="ZAM_Highway-1_1_T-1", histories=histories,
        agent_status={aid: status for aid in histories},
        agent_messages={aid: "success" for aid in histories})


@pytest.mark.parametrize("fn", ["plot_final", "plot_multiagent_overview"])
def test_run_plots_same_pixels(tmp_path, fn):
    rng = np.random.default_rng(5)
    jsc, tsc = _scenarios()
    res = _result(rng, 3)
    got = {name: getattr(mod, fn)(sc, res, save_path=str(tmp_path / name / "out.png"))
           for name, mod, sc in (("jax", jvis, jsc), ("torch", tvis, tsc))}
    assert_same_png(got["jax"], got["torch"])


def test_make_gif_same_frames(tmp_path):
    rng = np.random.default_rng(2)
    frames = tmp_path / "frames"
    frames.mkdir()
    for t in (10, 5, 15):
        Image.fromarray(rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)).save(
            frames / f"frame_{t:04d}.png")
    want = jvis.make_gif(str(frames), str(tmp_path / "jax.gif"))
    got = tvis.make_gif(str(frames), str(tmp_path / "torch.gif"))
    a = [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(Image.open(want))]
    b = [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(Image.open(got))]
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        assert np.array_equal(fa, fb)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tvis.make_gif(str(empty), str(tmp_path / "none.gif")) is None


def test_live_mode_reuses_one_figure(tmp_path):
    """Two `show=True` frames draw into one figure, in both packages, and
    the second live frame has the same pixels."""
    rng = np.random.default_rng(4)
    jsc, tsc = _scenarios()
    agents = _agents(rng)
    plt.close("all")
    out = {}
    for name, mod, sc in (("jax", jvis, jsc), ("torch", tvis, tsc)):
        mod._live_fig = None
        fig1, _ = mod.plot_scenario_at_timestep(sc, agents, 5, show=True)
        n_open = len(plt.get_fignums())
        path = mod.plot_scenario_at_timestep(
            sc, agents, 10, show=True, save_path=str(tmp_path / name / "live.png"))
        assert mod._live_fig is fig1 and len(plt.get_fignums()) == n_open == 1
        out[name] = path
        plt.close("all")
        mod._live_fig = None
    assert_same_png(out["jax"], out["torch"])


# ---------------------------------------------------------------- risk charts


@pytest.mark.parametrize("fn", ["plot_trajectory_risk", "plot_harm_breakdown"])
def test_candidate_risk_charts_same_pixels(tmp_path, fn):
    jr, tr = random_risks(np.random.default_rng(8), M, 5)
    got = {name: getattr(mod, fn)(r, None, save_path=str(tmp_path / f"{name}.png"),
                                  candidate=3)
           if fn == "plot_trajectory_risk" else
           getattr(mod, fn)(r, save_path=str(tmp_path / f"{name}.png"), candidate=3)
           for name, mod, r in (("jax", jrisk_vis, jr), ("torch", trisk_vis, tr))}
    assert_same_png(got["jax"], got["torch"])


def test_risk_dashboard_same_pixels(tmp_path):
    rng = np.random.default_rng(9)
    jr, tr = random_risks(rng, M, 5)
    arrays = _fan(rng)
    got = {name: mod.risk_dashboard(_cycle_result(arrays, xp), r,
                                    save_path=str(tmp_path / f"{name}.png"))
           for name, mod, r, xp in (("jax", jrisk_vis, jr, jnp_array),
                                    ("torch", trisk_vis, tr, t64))}
    assert_same_png(got["jax"], got["torch"])


def test_plot_scenario_risk_same_pixels(tmp_path):
    rng = np.random.default_rng(10)
    jsc, tsc = _scenarios()
    agents = _agents(rng)
    jr, tr = random_risks(rng, M, 5)
    arrays = _fan(rng)
    got = {name: mod.plot_scenario_risk(sc, agents, _cycle_result(arrays, xp), r, 5,
                                        save_path=str(tmp_path / f"{name}.png"))
           for name, mod, sc, r, xp in (("jax", jrisk_vis, jsc, jr, jnp_array),
                                        ("torch", trisk_vis, tsc, tr, t64))}
    assert_same_png(got["jax"], got["torch"])


def test_plot_cost_composition_same_pixels(tmp_path):
    rng = np.random.default_rng(12)
    path = tmp_path / "logs.csv"
    terms = ["costs_acceleration", "costs_jerk", "costs_prediction",
             "costs_unweighted_jerk"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["trajectory_number", "optimal_trajectory_cost", *terms])
        for t in range(0, 60, 3):
            vals = rng.uniform(-0.5, 4.0, len(terms))
            w.writerow([t, f"{vals.sum():.6f}", *(f"{v:.6f}" for v in vals[:-1]), ""])
    got = {name: mod.plot_cost_composition(str(path), save_path=str(tmp_path / f"{name}.png"))
           for name, mod in (("jax", jrisk_vis), ("torch", trisk_vis))}
    assert_same_png(got["jax"], got["torch"])


# ---------------------------------------------------------------- the fetch


def test_fetch_buffer_splits_back_exactly():
    """`pack` / `unpack`, the one-copy buffer of `fetch`, give every dtype a
    plot reads back exactly; CPU tensors and arrays make no copy."""
    rng = np.random.default_rng(1)
    tensors = [torch.as_tensor(rng.normal(size=(4, 31)) * 1e3, dtype=torch.float32),
               torch.as_tensor(rng.normal(size=(4, 31)) * 1e3),
               torch.tensor([1e15, np.inf, -np.inf, 0.0]),
               torch.as_tensor(rng.uniform(size=7) < 0.5),
               torch.tensor(34815, dtype=torch.int32),
               torch.as_tensor(rng.integers(-2**40, 2**40, 5))]
    back = tvis.unpack(tvis.pack(tensors).numpy(), tensors)
    for t, b in zip(tensors, back):
        want = t.numpy()
        assert b.dtype == want.dtype and b.shape == want.shape
        assert np.array_equal(b, want)
    before = tvis.FETCHES
    got = tvis.fetch(tensors[0], None, np.arange(3), [1.0, 2.0])
    assert tvis.FETCHES == before
    assert got[1] is None and np.array_equal(got[0], tensors[0].numpy())
    assert got[3].dtype == np.float64

