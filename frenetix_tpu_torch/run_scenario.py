"""Command line: run scenarios through the PyTorch port.

Usage:
    python -m frenetix_tpu_torch.run_scenario PATH_OR_FAMILY [...]
        [--device cuda|cpu] [--config-dir DIR] [--multiagent]
        [--batched-agents]

Each argument is a CommonRoad XML file, a directory of them, or the name of
a synthetic scenario family of `frenetix_tpu_torch/io/scenario_factory.py`
(every `make_<family>` there: highway, curve, s_curve, overtake, lane_change,
convoy, ...).  `--multiagent` turns every dynamic obstacle into a planning
agent; `--batched-agents` evaluates all agents' cycles in one device pass.
One status row per agent goes to stdout; the exit code is 0 when every agent
reached its goal.  `--device cuda` without a CUDA device raises; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from frenetix_tpu_torch.io import scenario_factory
from frenetix_tpu_torch.io.commonroad import load_scenario
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import load_config

__all__ = ["FAMILIES", "load_target", "resolve_device", "run_scenarios", "main"]

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


def run_scenarios(targets, config, device: torch.device, out=sys.stdout):
    """Simulate each target; print and return one (name, SimulationResult)
    per scenario."""
    results = []
    for target in targets:
        scenario = load_target(target)
        res = Simulation(scenario, config, device).run()
        for aid, status in res.agent_status.items():
            print(f"{scenario.scenario_id} agent={aid} status={status.name} "
                  f"steps={res.steps} wall_s={res.wall_time:.3f} "
                  f"device={device} message={res.agent_messages[aid]!r}",
                  file=out, flush=True)
        results.append((target, res))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenarios", nargs="+",
                    help="CommonRoad XML files, directories of them, or family names")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ap.add_argument("--config-dir", default=None,
                    help="directory of YAML config files (needs PyYAML)")
    ap.add_argument("--multiagent", action="store_true",
                    help="convert dynamic obstacles into planning agents")
    ap.add_argument("--batched-agents", action="store_true",
                    help="multi-agent: evaluate ALL agents' cycles in one "
                         "batched device pass (parallel.batched_sim)")
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
    results = run_scenarios(targets, config, device)
    return 0 if all(res.success for _, res in results) else 1


if __name__ == "__main__":
    sys.exit(main())
