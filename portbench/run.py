"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up draws the cell's pool of requests from
the seed (plain NumPy), builds the program's inputs that stay (the road),
and warms up every program the cell's requests use.  The window then sends
the pool's requests in order, each when the last has returned (one client,
closed loop), for `--seconds`.  After it, the answers of a sample of
requests drawn from the seed are held against the plain reference (by the
configuration's own check, where it names one).

With `--trace 0` the result's metrics are the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read from `torch.profiler` over a
slice of the window's requests and from the program's counters.  The last
line of standard output is one JSON object; the numbers compared and their
limits are the last lines of standard error.  Without a CUDA device the
command exits with 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import e2e, entries, generate, judge, metrics, spec, trace

_IMPORTED_AT = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "frenetix_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Window:
    setup_s: float
    candidates: int                 # real candidates per request
    cycles: int = 1                 # planning cycles per request
    latencies_s: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    seconds: float = 0.0


@dataclass
class Run:
    """What the per-layer readers read."""

    entry: object
    k1_shape: tuple
    captures: int
    slice: object = None
    traced: list = field(default_factory=list)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device,
             *, bench=None, config=None, mix=None, setup_from=None):
    """The result dict of one run (see the module's doc), and the checks
    as (name, value, limit).  `config` and `mix` replace the cell's files
    (tests run smaller ones on the CPU)."""
    from frenetix_tpu_torch.utils import compiled

    bench = bench or spec.load()
    cell = spec.cell(bench, workload)
    config = config or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])

    clock = setup_from or process_age_s
    phases = {"imports": clock()}
    lines, pool = generate.pool_of(config, mix, seed)
    phases["pool"] = clock()
    entry = entries.load(config["entry"]).Entry(config, lines, device, tracing=traced)
    prepared = [entry.prepare(r) for r in pool]
    phases["inputs"] = clock()
    for i in range(config["warmup_requests"]):
        entry.request(prepared[i % len(prepared)])
        _sync(device)
        phases[f"warmup_{i}"] = clock()
    gc.collect()
    window = Window(setup_s=clock(),
                    candidates=getattr(entry, "candidates",
                                       config["agents"] * config["candidates_per_agent"]),
                    cycles=getattr(entry, "cycles", 1))

    run = Run(entry=entry, k1_shape=entry.k1_shape, captures=0)
    first, count = config["trace_after_requests"], config["trace_requests"]
    prof = None
    captures0 = compiled.CAPTURES
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        if traced and i == first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        span = (torch.profiler.record_function(trace.REQUEST_SPAN) if prof is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            answer = entry.request(prepared[i % len(prepared)])
        t1 = time.perf_counter()
        window.latencies_s.append(t1 - t0)
        window.answers.append(answer)
        i += 1
        if prof is not None and i == first + count:
            _sync(device)
            prof.__exit__(None, None, None)
            run.slice = trace.from_profiler(prof, count)
            run.traced = [prepared[j % len(prepared)] for j in range(first, first + count)]
            prof = None
        if t1 >= deadline and (not traced or run.slice is not None):
            break
    window.seconds = t1 - start
    run.captures = compiled.CAPTURES - captures0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    if traced:
        values = {m["name"]: metrics.load(m["name"]).read(run)
                  for m in spec.metrics_of(bench, workload, "per_layer")}
        result_metrics = {name: {"value": float(v), "unit": _unit(bench, name)}
                          for name, v in values.items() if v is not None}
    else:
        result_metrics = {m["name"]: {"value": float(e2e.function(m["name"])(window)),
                                      "unit": m["unit"]}
                          for m in spec.metrics_of(bench, workload, "end_to_end")}

    sl = run.slice
    entry.free()
    run, prepared = None, None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    lims = judge.limits(cell["config"], config)
    picks = judge.sample(len(window.answers), config["check_requests"], seed)
    numbers, failed = dict.fromkeys(judge.numbers_of(config), 0.0), 0
    for k in picks:
        got = judge.compare_one(config, lines, pool[k % len(pool)],
                                entry.answer(window.answers[k]), device=device)
        failed += not judge.verdict(got, lims)
        judge.fold(numbers, got)

    lat = np.asarray(window.latencies_s) * 1e3
    found = np.concatenate([entry.answer(a)["found"] for a in window.answers[:len(pool)]])
    result = {
        "correct": judge.verdict(numbers, lims),
        "attempted": len(window.answers),
        "failed": failed,
        "metrics": result_metrics,
        "device": _device(device, peak, sl),
        "notes": {"workload": workload, "seed": seed, "p50_ms": float(np.median(lat)),
                  "requests": len(lat), "window_s": window.seconds,
                  "checked": len(picks), "found_share": float(found.mean()),
                  "setup_phases_s": phases},
    }
    if sl is not None:
        result["breakdown"] = {"device_ops": sl.top_ops(), "idle_gaps": sl.idle_by_host()}
    return result, [(k, numbers[k], lims[k]) for k in lims], window


def _unit(bench, name):
    return next(m["unit"] for m in bench["per_layer"] if m["name"] == name)


def _device(device, peak, sl):
    if device.type != "cuda":
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": int(peak)}
    if sl is not None:
        out.update(busy_s=sl.busy_s, window_s=sl.wall_s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, checks, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    for k, v, lim in checks:
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
