"""Matplotlib pictures of scenarios, candidates, predictions and runs.

The port's copy of `frenetix_tpu/utils/visualization.py`: per-step frames
(lanelet network, ego and obstacle boxes, the candidate fan colored by cost
or red when rejected, prediction means with 1σ ellipses, the reference
path, the executed history), the whole run's final plot, the multi-agent
overview and the GIF.  Same signatures, artists, colors, z-orders, dpi and
`bbox_inches` as the JAX package, so the same inputs give the same pixels.

Plot inputs may be tensors on any device: every field read from a
CycleResult, Rollout, TrajectoryRisks or prediction dict goes through
`fetch`, which brings the tensors of one picture over in ONE device-to-host
copy (counted in `FETCHES`).  matplotlib and PIL are imported inside the
functions, so the module imports on a machine that has neither;
`check_plot_packages` says before a run starts that it could not draw.
"""
from __future__ import annotations

import importlib
import os

import numpy as np
import torch

__all__ = [
    "plot_scenario_at_timestep",
    "plot_final",
    "plot_multiagent_overview",
    "make_gif",
    "fetch",
    "pack",
    "unpack",
    "check_plot_packages",
    "replay_device_frames",
    "write_run_gif",
]

# the one live window reused across frames when show=True
_live_fig = None

# device-to-host copies made by `fetch` (tensors off the CPU only)
FETCHES = 0


def pack(tensors) -> torch.Tensor:
    """The tensors flattened, cast to float64 and concatenated on their
    device: one buffer for one copy."""
    return torch.cat([x.detach().reshape(-1).to(torch.float64) for x in tensors])


def unpack(host: np.ndarray, tensors) -> list:
    """`pack`'s buffer on the host, split back into arrays of the tensors'
    shapes and dtypes (exact for floats up to float64, bools and integers
    up to 2**53)."""
    out, start = [], 0
    for x in tensors:
        dtype = torch.empty((), dtype=x.dtype).numpy().dtype
        out.append(host[start:start + x.numel()].reshape(tuple(x.shape)).astype(dtype))
        start += x.numel()
    return out


def fetch(*xs):
    """NumPy arrays of tensors on any device, arrays or None, in order.  The
    tensors that lie off the CPU come over in ONE device-to-host copy
    (`pack` on their device, `unpack` on the host), counted in FETCHES."""
    global FETCHES
    out = list(xs)
    on_device = [i for i, x in enumerate(xs)
                 if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if on_device:
        tensors = [xs[i] for i in on_device]
        host = pack(tensors).cpu().numpy()
        FETCHES += 1
        for i, arr in zip(on_device, unpack(host, tensors)):
            out[i] = arr
    for i, x in enumerate(out):
        if isinstance(x, torch.Tensor):
            out[i] = x.detach().numpy()
        elif x is not None:
            out[i] = np.asarray(x)
    return tuple(out)


def _require(package, what):
    try:
        importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{what} needs {package}, which does not import here: {e}",
                          name=package) from e


def check_plot_packages(config, log_dir) -> None:
    """Raise ImportError naming the package when a run of `config` with
    `log_dir` will draw and matplotlib does not import (a run draws with
    `visualization.save_plots` and a log directory, or with `show_plots`),
    or when it will write the GIF (`save_gif` too) and PIL does not.
    Called before a run starts, before any device work: the run does not
    start.  The JAX package raises the same ImportError later, at its first
    frame (or, for a device-resident run, after the whole run)."""
    vis = config.visualization
    saves = bool(vis.save_plots and log_dir)
    if not (saves or vis.show_plots):
        return
    _require("matplotlib", "visualization.save_plots / show_plots")
    if saves and vis.save_gif:
        _require("PIL", "visualization.save_gif")


def _draw_lanelets(ax, scenario):
    for ll in scenario.lanelets.values():
        ax.fill(
            *ll.polygon.T, facecolor="#e8e8e8", edgecolor="none", zorder=0
        )
    for ll in scenario.lanelets.values():
        ax.plot(*ll.left_vertices.T, color="#555", lw=0.6, zorder=1)
        ax.plot(*ll.right_vertices.T, color="#555", lw=0.6, zorder=1)


def _vehicle_patch(ax, pos, theta, length, width, color, zorder=10, alpha=1.0):
    from matplotlib.patches import Rectangle
    from matplotlib.transforms import Affine2D

    rect = Rectangle(
        (-length / 2, -width / 2), length, width,
        facecolor=color, edgecolor="black", lw=0.5, zorder=zorder, alpha=alpha,
    )
    rect.set_transform(
        Affine2D().rotate(theta).translate(pos[0], pos[1]) + ax.transData
    )
    ax.add_patch(rect)


def _windshield_patch(ax, pos, theta, length, width, zorder=10):
    """Minimal vehicle 'icon' (visualization.yaml draw_icons): a darker
    windshield trapezoid on the front third of the body box."""
    from matplotlib.patches import Polygon as MplPolygon

    ca, sa = np.cos(theta), np.sin(theta)
    rot = np.array([[ca, -sa], [sa, ca]])
    shape = np.array([
        [0.10 * length, 0.40 * width], [0.25 * length, 0.32 * width],
        [0.25 * length, -0.32 * width], [0.10 * length, -0.40 * width],
    ])
    ax.add_patch(MplPolygon(shape @ rot.T + np.asarray(pos), closed=True,
                            facecolor="#223344", alpha=0.8, zorder=zorder))


def _cov_ellipse(ax, mean, cov, color, n_sigma=1.0, alpha=0.25, zorder=5):
    from matplotlib.patches import Ellipse

    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, 1e-9)
    ang = np.degrees(np.arctan2(vecs[1, 1], vecs[0, 1]))
    e = Ellipse(mean, 2 * n_sigma * np.sqrt(vals[1]), 2 * n_sigma * np.sqrt(vals[0]),
                angle=ang, facecolor=color, alpha=alpha, zorder=zorder)
    ax.add_patch(e)


def plot_scenario_at_timestep(
    scenario, agents, t, *, cycle_result=None, matrix_mask=None, predictions=None,
    save_path=None, window=60.0, veh_length=4.508, veh_width=1.61, show_ref=True,
    visible_area=None, show_labels=True, draw_planning_problem=True,
    draw_icons=False, show=False,
):
    """One frame: scenario + agents + (optional) candidate set + predictions.

    cycle_result: a planner CycleResult to draw all candidates, colored by
    cost; its x, y, cost, selectable, best_idx and `matrix_mask` come to the
    host in one copy.  visible_area: a sim.visible_area.VisibleArea to
    overlay the sensor's visible region.  show_labels /
    draw_planning_problem / draw_icons mirror the visualization.yaml flags
    of the same names (goal regions as filled polygons; icons draw a
    windshield wedge on the vehicle box).  `show` (visualization.yaml
    show_plots): draw on the current interactive backend, reusing one
    figure across frames, and pause briefly instead of forcing Agg.
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    global _live_fig
    if show and _live_fig is not None and plt.fignum_exists(_live_fig.number):
        # live mode keeps ONE window open across steps
        fig = _live_fig
        fig.clf()
        ax = fig.add_subplot(111)
    else:
        fig, ax = plt.subplots(figsize=(11, 9))
        if show:
            _live_fig = fig
    _draw_lanelets(ax, scenario)

    if visible_area is not None:
        from matplotlib.patches import Polygon as MplPolygon

        ax.add_patch(MplPolygon(
            visible_area.polygon(), closed=True, facecolor="#ffdd55",
            edgecolor="#bb9900", alpha=0.25, zorder=2,
        ))

    # planning problems: goal regions (visualization.yaml draw_planning_problem)
    if draw_planning_problem:
        from matplotlib.patches import Polygon as MplPolygon

        for a in agents:
            for g in getattr(a.problem, "goals", []):
                if getattr(g, "position_shape", None) is not None:
                    ax.add_patch(MplPolygon(
                        np.asarray(g.position_shape), closed=True,
                        facecolor="#ccddaa", edgecolor="#558833", alpha=0.5,
                        zorder=3,
                    ))

    # scenario obstacles at t
    agent_ids = {a.id for a in agents}
    for ob in scenario.obstacles.values():
        if ob.obstacle_id in agent_ids:
            continue
        st = ob.state_at_time(t)
        if st is None:
            continue
        _vehicle_patch(ax, st.position, st.orientation, ob.length, ob.width,
                       "#4477aa", zorder=8)
        if draw_icons:
            _windshield_patch(ax, st.position, st.orientation, ob.length,
                              ob.width, zorder=9)
        if show_labels:
            ax.annotate(str(ob.obstacle_id), st.position, fontsize=7, zorder=20)

    # candidate fan of the first agent
    if cycle_result is not None:
        ro = cycle_result.rollout
        x, y, cost, ok, mask, best = fetch(
            ro.x, ro.y, cycle_result.cost, cycle_result.selectable, matrix_mask,
            cycle_result.best_idx)
        if mask is None:
            mask = np.ones(len(x), bool)
        finite = cost[ok & mask]
        cmin, cmax = (finite.min(), finite.max()) if len(finite) else (0, 1)
        import matplotlib.cm as cm

        for i in range(len(x)):
            if not mask[i]:
                continue
            if ok[i]:
                c = cm.viridis(1 - (cost[i] - cmin) / max(cmax - cmin, 1e-9))
                ax.plot(x[i], y[i], color=c, lw=0.4, alpha=0.5, zorder=4)
            else:
                ax.plot(x[i], y[i], color="#cc3333", lw=0.25, alpha=0.15, zorder=3)
        best = int(best)
        ax.plot(x[best], y[best], color="#00cc44", lw=2.0, zorder=12)

    # predictions (means + 1σ ellipses every 5th step)
    if predictions is not None:
        means, covs, valid = fetch(predictions["means"], predictions["covs"],
                                   predictions["valid"])
        for k in range(means.shape[0]):
            if not valid[k].any():
                continue
            n = int(valid[k].sum())
            ax.plot(means[k, :n, 0], means[k, :n, 1], color="#ee7733", lw=1.0, zorder=6)
            for j in range(0, n, 5):
                _cov_ellipse(ax, means[k, j], covs[k, j], "#ee7733")

    # agents: history + box + reference path
    colors = ["#228833", "#aa3377", "#66ccee", "#ccbb44", "#b86a22", "#994455"]
    center = None
    for idx, a in enumerate(agents):
        col = colors[idx % len(colors)]
        hist = np.array([s.position for s in a.record.states])
        ax.plot(hist[:, 0], hist[:, 1], color=col, lw=1.2, zorder=9)
        _vehicle_patch(ax, a.state.position, a.state.orientation,
                       veh_length, veh_width, col, zorder=11)
        if draw_icons:
            _windshield_patch(ax, a.state.position, a.state.orientation,
                              veh_length, veh_width, zorder=12)
        if show_labels:
            ax.annotate(str(a.id), a.state.position, fontsize=7, zorder=20)
        if show_ref and a.planner.ref_np is not None:
            ax.plot(*np.asarray(a.planner.ref_np.xy).T, "--", color=col,
                    lw=0.6, alpha=0.5, zorder=2)
        if center is None:
            center = a.state.position
    if center is not None:
        ax.set_xlim(center[0] - window, center[0] + window)
        ax.set_ylim(center[1] - window * 0.75, center[1] + window * 0.75)
    ax.set_aspect("equal")
    ax.set_title(f"{scenario.scenario_id} — t = {t}")
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        if not show:
            plt.close(fig)
            return save_path
    if show:
        try:
            plt.ion()
            fig.show()
            plt.pause(0.001)
        except Exception:
            pass  # headless backend: live display unavailable
        # the window stays open (reused next frame via _live_fig)
        if save_path:
            return save_path
    return fig, ax


def plot_final(scenario, result, save_path=None):
    """Whole-run overview: all executed trajectories colored by velocity."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 9))
    _draw_lanelets(ax, scenario)
    for aid, states in result.histories.items():
        xy = np.array([s.position for s in states])
        v = np.array([s.velocity for s in states])
        sc = ax.scatter(xy[:, 0], xy[:, 1], c=v, s=4, cmap="plasma", zorder=8)
        ax.annotate(str(aid), xy[0], fontsize=8, zorder=20)
    fig.colorbar(sc, ax=ax, label="v [m/s]", shrink=0.7)
    ax.set_aspect("equal")
    ax.set_title(f"{result.scenario_id} — final trajectories")
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        fig.savefig(save_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, ax


def make_gif(frame_dir, out_path, fps=10):
    """Assemble the PNG frames of `frame_dir` (in name order) into a GIF."""
    from PIL import Image

    frames = sorted(
        os.path.join(frame_dir, f) for f in os.listdir(frame_dir) if f.endswith(".png")
    )
    if not frames:
        return None
    imgs = [Image.open(f) for f in frames]
    base = imgs[0]
    base.save(
        out_path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
    return out_path


def plot_multiagent_overview(scenario, result, save_path=None, max_agents=11):
    """Multi-agent overview: one combined map plus a per-agent panel with its
    trajectory, final status and velocity profile."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    aids = list(result.histories.keys())[:max_agents]
    n = len(aids) + 1
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    fig, axs = plt.subplots(rows, cols, figsize=(6 * cols, 5 * rows))
    axs = np.atleast_1d(axs).ravel()

    # combined map
    ax = axs[0]
    _draw_lanelets(ax, scenario)
    cmap = plt.get_cmap("tab10")
    for k, aid in enumerate(aids):
        xy = np.array([s.position for s in result.histories[aid]])
        ax.plot(xy[:, 0], xy[:, 1], color=cmap(k % 10), lw=1.5, zorder=8,
                label=str(aid))
        ax.annotate(str(aid), xy[0], fontsize=7, zorder=20)
    ax.set_aspect("equal")
    ax.legend(fontsize=7, loc="best")
    ax.set_title(f"{result.scenario_id} — all agents")

    # per-agent panels
    for k, aid in enumerate(aids):
        ax = axs[k + 1]
        _draw_lanelets(ax, scenario)
        states = result.histories[aid]
        xy = np.array([s.position for s in states])
        v = np.array([s.velocity for s in states])
        pts = ax.scatter(xy[:, 0], xy[:, 1], c=v, s=5, cmap="plasma", zorder=8)
        fig.colorbar(pts, ax=ax, shrink=0.6, label="v [m/s]")
        status = result.agent_status.get(aid)
        msg = result.agent_messages.get(aid, "")
        ax.set_aspect("equal")
        ax.set_title(
            f"agent {aid}: {getattr(status, 'name', status)} ({msg})", fontsize=9
        )
        pad = 12.0
        ax.set_xlim(xy[:, 0].min() - pad, xy[:, 0].max() + pad)
        ax.set_ylim(xy[:, 1].min() - pad, xy[:, 1].max() + pad)
    for ax in axs[n:]:
        ax.axis("off")

    fig.suptitle(f"{result.scenario_id} — multi-agent overview")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, axs


def replay_device_frames(sim, res) -> None:
    """The per-step frames (and the GIF) of a device-resident run of `sim`,
    drawn afterwards from its fetched histories `res` (a SimulationResult);
    the host loop draws them live inside `Simulation.run`.  Draws only with
    `visualization.save_plots` and the simulation's log directory.  Leaves
    each agent at its last drawn state."""
    config, log_dir = sim.config, sim.log_dir
    vis = config.visualization
    if not (vis.save_plots and log_dir is not None):
        return
    for t in range(1, res.steps + 1):
        if t % vis.plot_interval:
            continue
        for a in sim.agents:
            h = res.histories.get(a.id, [])
            j = min(t, len(h) - 1)
            if j >= 0:
                a.state = h[j]
                a.record.states = list(h[: j + 1])
        plot_scenario_at_timestep(
            sim.scenario, sim.agents, t,
            save_path=f"{log_dir}/frames/frame_{t:04d}.png",
            window=vis.window, veh_length=config.vehicle.length,
            veh_width=config.vehicle.width, show_ref=vis.draw_reference_path,
            show_labels=vis.show_labels,
            draw_planning_problem=vis.draw_planning_problem,
            draw_icons=vis.draw_icons,
        )
    if vis.save_gif:
        write_run_gif(log_dir)


def write_run_gif(log_dir):
    """`log_dir`/run.gif from the frames under `log_dir`/frames; a run too
    short for one frame has no frames directory and gets no GIF."""
    frames = f"{log_dir}/frames"
    if os.path.isdir(frames):
        return make_gif(frames, f"{log_dir}/run.gif")
    return None
