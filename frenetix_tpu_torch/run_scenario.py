"""Command line: run scenarios through the PyTorch port.

Usage:
    python -m frenetix_tpu_torch.run_scenario PATH_OR_FAMILY [...]
        [--device cuda|cpu] [--config-dir DIR] [--multiagent]
        [--batched-agents] [--device-sim] [--device-fleet [--chunk N]]
        [--logs DIR]

Each argument is a CommonRoad XML file, a directory of them, or the name of
a synthetic scenario family of `frenetix_tpu_torch/io/scenario_factory.py`
(every `make_<family>` there: highway, curve, s_curve, overtake, lane_change,
convoy, ...).  `--multiagent` turns every dynamic obstacle into a planning
agent; `--batched-agents` evaluates all agents' cycles in one device pass.
`--device-sim` keeps each whole run on the device with one fetch per run
(`parallel.device_sim.DeviceSimulation`); `--device-fleet` runs ALL scenarios
as one device run over a scenario axis with one fetch
(`parallel.device_sim.run_fleet`; `--chunk N` in groups of N).  With `--logs`
the rows also go to DIR/score_overview.csv.  `--config-dir DIR` merges every
DIR/<section>.yaml into the config: a behavior.yaml with
`use_behavior_planner: true` turns the behavior planner on in every mode.
One status row per agent goes to stdout; the exit code is 0 when every agent
reached its goal.  `--device cuda` without a CUDA device raises; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import torch

from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.io.commonroad import load_scenario
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import load_config

__all__ = ["FAMILIES", "load_target", "resolve_device", "run_scenarios",
           "run_device_fleet", "main"]

FAMILIES = tuple(sorted(name[len("make_"):] for name in dir(scenario_factory)
                        if name.startswith("make_")))


def load_target(target: str):
    """A Scenario from an XML path or a scenario-family name."""
    if target in FAMILIES:
        return getattr(scenario_factory, f"make_{target}")()
    return load_scenario(target)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def _report(scenario_id, res, device, out, logs=None):
    """One status row per agent to `out` and, with `logs`, to
    logs/score_overview.csv."""
    rows = [(scenario_id, aid, res.steps, status.name, res.agent_messages[aid],
             round(res.wall_time, 3)) for aid, status in res.agent_status.items()]
    for name, aid, steps, status, message, wall in rows:
        print(f"{name} agent={aid} status={status} steps={steps} wall_s={wall:.3f} "
              f"device={device} message={message!r}", file=out, flush=True)
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


def run_scenarios(targets, config, device: torch.device, out=None, logs=None):
    """Simulate each target; print and return one (name, SimulationResult)
    per scenario.  With `config.simulation.device_resident_sim` every run
    stays on the device (`Simulation.run` hands over to
    `parallel.device_sim.DeviceSimulation`)."""
    out = out or sys.stdout
    results = []
    for target in targets:
        scenario = load_target(target)
        res = Simulation(scenario, config, device).run()
        _report(scenario.scenario_id, res, device, out, logs)
        results.append((target, res))
    return results


def run_device_fleet(targets, config, device: torch.device, out=None,
                     chunk=None, logs=None):
    """All targets as ONE device run over a scenario axis with one fetch
    (`parallel.device_sim.run_fleet`); returns one (name, SimulationResult)
    per scenario."""
    from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, run_fleet

    out = out or sys.stdout
    sims = [DeviceSimulation(Simulation(load_target(t), config, device))
            for t in targets]
    results = []
    for target, ds, dres in zip(targets, sims, run_fleet(sims, chunk=chunk)):
        res = ds.to_simulation_result(dres)
        _report(ds.sim.scenario.scenario_id, res, device, out, logs)
        results.append((target, res))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenarios", nargs="+",
                    help="CommonRoad XML files, directories of them, or family names")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ap.add_argument("--config-dir", default=None,
                    help="directory of YAML config files, one per config section "
                         "(e.g. behavior.yaml); PyYAML, or the port's own reader")
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
    ap.add_argument("--logs", default=None,
                    help="directory for score_overview.csv (one row per agent)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    config = load_config(args.config_dir)
    if args.multiagent:
        config.simulation.start_multiagent = True
    if args.batched_agents:
        config.simulation.batched_device_agents = True
    targets = []
    for path in args.scenarios:
        if os.path.isdir(path):
            targets.extend(sorted(os.path.join(path, f) for f in os.listdir(path)
                                  if f.endswith(".xml")))
        else:
            targets.append(path)
    if args.device_fleet:
        results = run_device_fleet(targets, config, device, chunk=args.chunk,
                                   logs=args.logs)
    else:
        if args.device_sim:
            config.simulation.device_resident_sim = True
        results = run_scenarios(targets, config, device, logs=args.logs)
    return 0 if all(res.success for _, res in results) else 1


if __name__ == "__main__":
    sys.exit(main())
