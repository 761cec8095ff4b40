"""Command line: run scenarios through the PyTorch port.

Usage:
    python -m frenetix_tpu_torch.run_scenario PATH_OR_FAMILY [...]
        [--device cuda|cpu | --cpu] [--config-dir DIR] [--set KEY=VALUE ...]
        [--multiagent] [--batched-agents] [--device-sim]
        [--device-fleet [--chunk N]] [--prediction MODE] [--evaluate]
        [--logs DIR] [--no-logging] [--workers N] [--plot] [--gif]

Each argument is a CommonRoad XML file, a directory of them, or the name of
a synthetic scenario family of `frenetix_tpu_torch/io/scenario_factory.py`
(every `make_<family>` there: highway, curve, s_curve, overtake, lane_change,
convoy, ...).  `--multiagent` turns every dynamic obstacle into a planning
agent; `--batched-agents` evaluates all agents' cycles in one device pass.
`--device-sim` keeps each whole run on the device with one fetch per run
(`parallel.device_sim.DeviceSimulation`); `--device-fleet` runs ALL scenarios
as one device run over a scenario axis with one fetch
(`parallel.device_sim.run_fleet`; `--chunk N` in groups of N).
`--workers N` runs the scenarios in N spawned worker processes
(`run_pipeline`, the JAX CLI's scenario pipeline), each on `--device`:
several workers share one card.

`--config-dir DIR` merges every DIR/<section>.yaml into the config (a
behavior.yaml with `use_behavior_planner: true` turns the behavior planner
on in every mode); `--set KEY=VALUE` (repeatable) merges dotted overrides
last, e.g. `--set planning.replanning_frequency=1 --set vehicle.cr_vehicle_id=2`,
and an unknown key fails.

Logs, as the JAX package's CLI writes them: DIR/messages.log,
DIR/score_overview.csv (one row per agent), DIR/log_failures.csv (a
scenario that raised, with its traceback) and, unless `--no-logging`, per
scenario DIR/<name>/simulation.db and per agent DIR/<name>/<agent>/
(trajectories.db, logs.csv).  `--evaluate` computes the criticality metrics
(the `scenario_evaluation` table), the vehicle-dynamics solution check and a
DIR/<name>/solution_<agent>.xml with its WX1 cost per successful agent;
`evaluation.yaml` can ask for each part alone.  A device fleet writes only
the score rows and evaluates in memory, as the JAX package's fleet does.
`--plot` draws every fifth step's frame to DIR/<name>/frames/ (a device run
draws them afterwards from its fetched histories), DIR/<name>/final.png and,
with several agents, DIR/<name>/overview.png; `--gif` also assembles the
frames into DIR/<name>/run.gif.  Plotting needs matplotlib (and PIL for the
GIF): without it the scenario fails before it starts, with an ImportError
naming the package in log_failures.csv.  A device fleet draws nothing.

One status row per agent goes to stdout; the exit code is 0 when every agent
of every scenario reached its goal and no scenario failed.  `--device cuda`
(the default) without a CUDA device raises; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
import traceback

import torch

from frenetix_tpu_torch.evaluation import evaluate_simulation
from frenetix_tpu_torch.evaluation.metrics import enabled_metrics
from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.io.commonroad import load_scenario
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import (
    load_config, merge_overrides, parse_cli_overrides,
)
from frenetix_tpu_torch.utils import tracing, visualization
from frenetix_tpu_torch.utils.logging import make_msg_logger
from frenetix_tpu_torch.utils.sim_logging import SimulationLogger

__all__ = ["FAMILIES", "load_target", "resolve_device", "run_one", "run_scenarios",
           "run_device_fleet", "run_pipeline", "main"]

FAMILIES = tuple(sorted(name[len("make_"):] for name in dir(scenario_factory)
                        if name.startswith("make_")))


def load_target(target: str):
    """A Scenario from an XML path or a scenario-family name."""
    if target in FAMILIES:
        return getattr(scenario_factory, f"make_{target}")()
    return load_scenario(target)


def target_name(target: str) -> str:
    """The name of a target's log directory: the file name without its
    extension, or the family name."""
    return os.path.splitext(os.path.basename(target))[0]


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def run_one(path, config, msg_logger=None, log_dir=None, evaluate=False, *,
            device=None):
    """One scenario end to end, as the JAX package's `run_one`: with
    `log_dir` and `debug.activate_logging` a SimulationLogger (meta, per-step
    timing, results) and the agents' trajectory logs under `log_dir`; the run
    on the host, or on the device with `simulation.device_resident_sim`; then
    `evaluate_simulation` as `evaluate` or `config.evaluation` asks.  With
    `visualization.save_plots` and `log_dir` the run's frames (replayed from
    the fetched histories for a device run), final.png and, with several
    agents, overview.png under `log_dir`; without matplotlib (or PIL for
    the GIF) that raises ImportError before the scenario loads.  `device`
    defaults to the CUDA device.  `path` is a CommonRoad XML file or a
    family name (`load_target`)."""
    visualization.check_plot_packages(config, log_dir)
    scenario = load_target(path)
    # --evaluate forces both; evaluation.yaml toggles enable them one by one
    ev = config.evaluation
    do_metrics = evaluate or ev.evaluate_simulation
    do_solution_check = evaluate or ev.evaluate_agents
    sim_logger = None
    if log_dir is not None and config.debug.activate_logging:
        sim_logger = SimulationLogger(
            log_dir,
            evaluation_metrics=(enabled_metrics(ev.criticality_metrics)
                                if do_metrics else None),
        )
    try:
        t0 = time.perf_counter()
        sim = Simulation(scenario, config, device, msg_logger=msg_logger,
                         sim_logger=sim_logger, log_dir=log_dir)
        init_time = time.perf_counter() - t0
        if sim_logger:
            sim_logger.log_meta(
                scenario.scenario_id, [a.id for a in sim.agents],
                list(scenario.planning_problems.keys()), init_time,
                {"prediction_mode": config.prediction.mode},
                {"cost_weights": config.cost_weights},
            )
        # with simulation.device_resident_sim the whole run on the device,
        # one fetch, no per-step rows (as in the JAX package); its frames
        # are replayed from the fetched histories
        res = sim.run()
        if log_dir is not None and config.visualization.save_plots:
            visualization.plot_final(scenario, res,
                                     save_path=os.path.join(log_dir, "final.png"))
            if len(res.histories) > 1:
                visualization.plot_multiagent_overview(
                    scenario, res, save_path=os.path.join(log_dir, "overview.png"))
        if do_metrics or do_solution_check:
            # a solution-check-only run skips the metric suite and must not
            # feed a logger whose scenario_evaluation table was never created
            evaluate_simulation(scenario, res, config,
                                sim_logger if do_metrics else None,
                                metrics=None if do_metrics else [],
                                msg_logger=msg_logger,
                                check_solutions=do_solution_check,
                                log_dir=log_dir)
    finally:
        if sim_logger:
            sim_logger.close()
    return res


def _rows(scenario_id, res) -> list:
    """One status row per agent: (scenario, agent, steps, status, message,
    wall seconds)."""
    return [(scenario_id, aid, res.steps, status.name, res.agent_messages[aid],
             round(res.wall_time, 3)) for aid, status in res.agent_status.items()]


def _report(rows, device, out, logs=None, msg_logger=None):
    """The status rows to `out`, to `msg_logger` and, with `logs`, to
    logs/score_overview.csv."""
    for name, aid, steps, status, message, wall in rows:
        print(f"{name} agent={aid} status={status} steps={steps} wall_s={wall:.3f} "
              f"device={device} message={message!r}", file=out, flush=True)
        if msg_logger:
            msg_logger.info(f"{name} agent {aid}: {status} ({message}) "
                            f"steps={steps} wall={wall:.1f}s")
    if logs is not None:
        os.makedirs(logs, exist_ok=True)
        path = os.path.join(logs, "score_overview.csv")
        new_file = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f, delimiter=";")
            if new_file:
                w.writerow(["scenario", "agent", "timestep", "status", "message",
                            "wall_s"])
            w.writerows(rows)


def _record_failure(logs, name, error, trace, msg_logger=None):
    """A scenario that raised: one row with the exception's repr and its
    traceback in logs/log_failures.csv."""
    if msg_logger:
        msg_logger.error(f"{name} FAILED: {error}")
    os.makedirs(logs, exist_ok=True)
    with open(os.path.join(logs, "log_failures.csv"), "a", newline="") as f:
        csv.writer(f, delimiter=";").writerow([name, error, trace])


def run_scenarios(targets, config, device: torch.device, out=None, logs=None, *,
                  evaluate=False, no_logging=False, msg_logger=None):
    """Simulate each target through `run_one`; print and return one
    (name, SimulationResult) per scenario.  With `logs` the score rows go to
    logs/score_overview.csv, each scenario's logs to logs/<name> (not with
    `no_logging`), and a scenario that raises is written to
    logs/log_failures.csv and returned as (name, None); without `logs` the
    exception propagates.  With `config.simulation.device_resident_sim`
    every run stays on the device."""
    out = out or sys.stdout
    results = []
    for target in targets:
        log_dir = None
        if logs is not None and not no_logging:
            log_dir = os.path.join(logs, target_name(target))
        try:
            res = run_one(target, config, msg_logger, log_dir=log_dir,
                          evaluate=evaluate, device=device)
        except Exception as e:
            if logs is None:
                raise
            _record_failure(logs, target_name(target), repr(e), traceback.format_exc(),
                            msg_logger)
            results.append((target, None))
            continue
        _report(_rows(res.scenario_id, res), device, out, logs, msg_logger)
        results.append((target, res))
    return results


def run_device_fleet(targets, config, device: torch.device, out=None,
                     chunk=None, logs=None, *, evaluate=False, msg_logger=None):
    """All targets as ONE device run over a scenario axis with one fetch
    (`parallel.device_sim.run_fleet`); returns one (name, SimulationResult)
    per scenario.  As the JAX package's fleet: no per-scenario logs; with
    `evaluate` each member's metrics are computed in memory (and summarized
    to `msg_logger`).  With `logs` a scenario that fails to build is written
    to logs/log_failures.csv and returned as (name, None)."""
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, run_fleet

    out = out or sys.stdout
    members, results = [], []
    for target in targets:
        try:
            members.append((target, DeviceSimulation(Simulation(
                load_target(target), config, device, msg_logger=msg_logger))))
        except Exception as e:      # containment: dropped from the fleet
            if logs is None:
                raise
            _record_failure(logs, target_name(target), repr(e), traceback.format_exc(),
                            msg_logger)
            results.append((target, None))
    if not members:
        return results
    sims = [ds for _, ds in members]
    for (target, ds), dres in zip(members, run_fleet(sims, chunk=chunk)):
        res = ds.to_simulation_result(dres)
        _report(_rows(ds.sim.scenario.scenario_id, res), device, out, logs, msg_logger)
        if evaluate:
            evaluate_simulation(ds.sim.scenario, res, config, None,
                                msg_logger=msg_logger, check_solutions=False)
        results.append((target, res))
    return results


def _pipeline_init(device: str, workers: int) -> None:
    """Worker start-up: CPU workers share the host's cores evenly (the
    threads of workers that each take all cores spin against one another)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


def _pipeline_worker(payload):
    """One scenario end to end in a spawned worker process: (target, status
    rows, None, K1 launches), or (target, None, (repr, traceback), K1
    launches) when it raised."""
    target, config, device, logs, evaluate, no_logging = payload
    log_dir = None if no_logging else os.path.join(logs, target_name(target))
    k1 = tracing.COUNTERS.get("kernel.k1.launches", 0)
    try:
        res = run_one(target, config, None, log_dir=log_dir, evaluate=evaluate,
                      device=device)
    except Exception as e:      # containment: the pipeline goes on
        return (target, None, (repr(e), traceback.format_exc()),
                tracing.COUNTERS.get("kernel.k1.launches", 0) - k1)
    return (target, _rows(res.scenario_id, res), None,
            tracing.COUNTERS.get("kernel.k1.launches", 0) - k1)


def run_pipeline(targets, config, device: torch.device, workers: int, out=None,
                 logs="logs", *, evaluate=False, no_logging=False, msg_logger=None):
    """The scenario pipeline: every target through `run_one` in a pool of
    `workers` spawned processes, each on `device` (the JAX CLI's
    `--workers`).  Score rows, printed lines and log_failures.csv as the
    sequential run writes them, in the order of the targets; returns one
    (target, every agent at its goal or None when it raised, the K1 kernel
    launches of its run) per scenario."""
    import concurrent.futures as cf
    import multiprocessing as mp

    out = out or sys.stdout
    payloads = [(t, config, str(device), logs, evaluate, no_logging) for t in targets]
    results = []
    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                initializer=_pipeline_init,
                                initargs=(str(device), workers)) as ex:
        for target, rows, err, launches in ex.map(_pipeline_worker, payloads):
            if err is not None:
                _record_failure(logs, target_name(target), *err, msg_logger)
                results.append((target, None, launches))
                continue
            _report(rows, device, out, logs, msg_logger)
            results.append((target, all(r[3] == "COMPLETED_SUCCESS" for r in rows),
                            launches))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenarios", nargs="+",
                    help="CommonRoad XML files, directories of them, or family names")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cuda (the default) or cpu")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, as --device cpu (the JAX CLI's flag)")
    ap.add_argument("--config-dir", default=None,
                    help="directory of YAML config files, one per config section "
                         "(e.g. behavior.yaml); PyYAML, or the port's own reader")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override merged last, e.g. "
                         "--set planning.replanning_frequency=1; an unknown key "
                         "fails")
    ap.add_argument("--multiagent", action="store_true",
                    help="convert dynamic obstacles into planning agents")
    ap.add_argument("--batched-agents", action="store_true",
                    help="multi-agent: evaluate ALL agents' cycles in one "
                         "batched device pass (parallel.batched_sim)")
    ap.add_argument("--device-sim", action="store_true",
                    help="run each WHOLE simulation on the device (one fetch "
                         "per run; parallel/device_sim.py)")
    ap.add_argument("--device-fleet", action="store_true",
                    help="run ALL scenarios as ONE device run over a scenario "
                         "axis with a single fetch (parallel.device_sim.run_fleet)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="--device-fleet: run the fleet in groups of this size")
    ap.add_argument("--prediction", default=None,
                    choices=["ground_truth", "constant_velocity", "walenet"])
    ap.add_argument("--evaluate", action="store_true",
                    help="criticality metrics, solution check and solution XML "
                         "after each simulation")
    ap.add_argument("--logs", default="logs",
                    help="directory of messages.log, score_overview.csv, "
                         "log_failures.csv and the per-scenario logs")
    ap.add_argument("--no-logging", action="store_true",
                    help="no per-scenario logs (simulation.db, trajectory logs)")
    ap.add_argument("--workers", type=int, default=1,
                    help="run the scenarios in this many spawned worker processes, "
                         "each on --device")
    ap.add_argument("--plot", action="store_true", help="save per-step frames")
    ap.add_argument("--gif", action="store_true", help="assemble frames into a GIF")
    args = ap.parse_args(argv)
    if args.cpu and args.device not in (None, "cpu"):
        ap.error(f"--cpu conflicts with --device {args.device}")

    device = resolve_device("cpu" if args.cpu else args.device or "cuda")
    config = load_config(args.config_dir)
    merge_overrides(config, parse_cli_overrides(args.set))
    # the flags only switch their option on (a --set of the same key is not
    # clobbered by a flag left off)
    if args.multiagent:
        config.simulation.start_multiagent = True
    if args.batched_agents:
        config.simulation.batched_device_agents = True
    if args.device_sim:
        config.simulation.device_resident_sim = True
    if args.prediction:
        config.prediction.mode = args.prediction
    if args.plot or args.gif:
        config.visualization.save_plots = True
        config.visualization.save_gif = args.gif
    targets = []
    for path in args.scenarios:
        if os.path.isdir(path):
            targets.extend(sorted(os.path.join(path, f) for f in os.listdir(path)
                                  if f.endswith(".xml")))
        else:
            targets.append(path)

    os.makedirs(args.logs, exist_ok=True)
    msg_logger = make_msg_logger(args.logs, level=config.simulation.msg_log_mode)
    if args.device_fleet:
        results = run_device_fleet(targets, config, device, chunk=args.chunk,
                                   logs=args.logs, evaluate=args.evaluate,
                                   msg_logger=msg_logger)
    elif args.workers > 1:
        return 0 if all(ok for _, ok, _ in run_pipeline(
            targets, config, device, args.workers, logs=args.logs,
            evaluate=args.evaluate, no_logging=args.no_logging,
            msg_logger=msg_logger)) else 1
    else:
        results = run_scenarios(targets, config, device, logs=args.logs,
                                evaluate=args.evaluate, no_logging=args.no_logging,
                                msg_logger=msg_logger)
    return 0 if all(res is not None and res.success for _, res in results) else 1


if __name__ == "__main__":
    sys.exit(main())
