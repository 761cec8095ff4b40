"""The readings the comparison's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 3 [--first-seed N]

In one process: for each of `--seeds` seeds a run of the cell with a short
window at the cell's own sizes and load, its answers held to the reference
as a run holds them (the lower readings: the program in float32); then for
`--control-seeds` seeds the control, the reference itself in bfloat16 put in
the program's place on the same sampled requests (the upper readings).
Prints to standard output one JSON line per seed and a summary line: the
largest program reading and the smallest control reading of each number.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import generate, judge, run, spec


def program_readings(workload, seed, seconds, device, bench):
    result, checks, _ = run.run_cell(workload, seed, seconds, False, device, bench=bench,
                                     setup_from=lambda: 0.0)
    return {k: v for k, v, _ in checks}, result["notes"]["requests"]


def control_readings(workload, seed, device, bench, dtype=torch.bfloat16):
    """The numbers of the control: the reference in `dtype` answers the
    sampled requests of the pool (the configuration's check's
    `control_answer` where it has one), held as a run holds the program's."""
    cell = spec.cell(bench, workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    lines, pool = generate.pool_of(config, mix, seed)
    answer = getattr(judge.check_of(config), "control_answer", judge.reference_answer)
    numbers = dict.fromkeys(judge.numbers_of(config), 0.0)
    for k in judge.sample(len(pool), config["check_requests"], seed):
        req = pool[k % len(pool)]
        judge.fold(numbers, judge.compare_one(
            config, lines, req, answer(config, lines, req, dtype=dtype, device=device),
            device=device))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.load()
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        numbers, requests = program_readings(args.workload, seed, args.seconds, device,
                                             bench)
        print(json.dumps({"side": "program", "seed": seed, "requests": requests,
                          **numbers}), flush=True)
        lower = {k: max(lower.get(k, 0.0), v) for k, v in numbers.items()}
    for i in range(args.control_seeds):
        seed = args.first_seed + 1000 + i
        numbers = control_readings(args.workload, seed, device, bench)
        print(json.dumps({"side": "control", "seed": seed, **numbers}), flush=True)
        upper = {k: min(upper.get(k, float("inf")), v) for k, v in numbers.items()}
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
