"""Multi-process initialization and scenario sharding.

PyTorch port of `frenetix_tpu/parallel/distributed.py`.  The JAX package
spans hosts with `jax.distributed` and shards agents over the devices of one
process with `shard_map`.  The PyTorch idiom is one process per card under a
`torchrun`-style launch, so here the mesh is a `torch.distributed` world:

  - `initialize()` joins the world that the launch describes (the torchrun
    contract: MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), with
    the NCCL backend for a CUDA device (after `torch.cuda.set_device` to the
    rank's local card) and gloo for the CPU;
  - every rank builds the same host state and runs the same host loop; only
    the agent (or scenario) axis is split over the ranks
    (`parallel.mesh.sharded_full_cycle`, `DeviceSimulation(mesh=...)`,
    `run_fleet(mesh=...)`), and the small per-agent results are all-gathered
    so that every rank ends each cycle with the same full results;
  - scenario-level parallelism across hosts needs no communication at all:
    `shard_scenarios` deals out the work.

A failed init or collective raises: nothing here falls back to another
backend, to eager execution or to one process.  A single-process launch (no
coordinator anywhere) is a no-op: `initialize()` returns False and
`process_info()` is (0, 1).

`run_world` starts a world of spawned processes on this host over a file
store (the tests, the dry run of `graft_entry` and chip_smoke use it).
"""
from __future__ import annotations

import csv
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_info", "shard_scenarios", "merge_score_csvs",
           "run_world"]


def initialize(coordinator_address=None, num_processes=None, process_id=None, *,
               init_method=None, local_rank=None, device="cuda") -> bool:
    """Join the torch.distributed world of this launch.

    Reads MASTER_ADDR / MASTER_PORT (the coordinator, "host:port"),
    WORLD_SIZE, RANK and LOCAL_RANK where the arguments are omitted, as the
    JAX package reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID.  `init_method` (e.g. "file:///path/store") takes the
    place of the coordinator.  Without either this is a no-op returning
    False.

    `device` is the device type the run's tensors live on: "cuda" joins with
    NCCL on the rank's local card (`torch.cuda.set_device(local_rank)`; a
    rank without its own card raises), "cpu" with gloo.  Returns True once
    the world exists (also when it existed already)."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                    f"{os.environ.get('MASTER_PORT', '29500')}")
        if coordinator_address is None:
            return False
        init_method = f"tcp://{coordinator_address}"
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("WORLD_SIZE", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("RANK", "0"))
    local_rank = int(local_rank if local_rank is not None
                     else os.environ.get("LOCAL_RANK", process_id))
    device_type = torch.device(device).type
    if device_type == "cuda":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= n_cards:
            raise RuntimeError(
                f"rank {process_id} (local rank {local_rank}) needs its own CUDA "
                f"device and this host has {n_cards}: NCCL takes one rank per card")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device type {device_type!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def process_info():
    """(rank, world size) of this process; (0, 1) without a world."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_scenarios(scenario_paths, process_id=None, num_processes=None):
    """Round-robin share of the scenario set for this process.

    Deterministic across processes: every one computes the same assignment
    from the same sorted list."""
    if process_id is None or num_processes is None:
        rank, world = process_info()
        process_id = rank if process_id is None else process_id
        num_processes = world if num_processes is None else num_processes
    paths = sorted(scenario_paths)
    return paths[process_id::num_processes]


def merge_score_csvs(log_dirs, out_path):
    """Concatenate per-host score_overview.csv files into one (same format
    as run_scenario.py's writer); None when no directory had one."""
    rows, header = [], None
    for d in log_dirs:
        p = os.path.join(d, "score_overview.csv")
        if not os.path.isfile(p):
            continue
        with open(p, newline="") as f:
            r = list(csv.reader(f, delimiter=";"))
        if not r:
            continue
        header = header or r[0]
        rows.extend(r[1:])
    if header is None:
        return None
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(header)
        w.writerows(rows)
    return out_path


def _world_rank(rank, fn, world, args, device, store, out_dir):
    """One spawned rank of `run_world`: join, run, leave, write the result.
    A CPU rank runs on one thread: ranks that each take several cores spin
    against one another and against whatever else the host runs."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    initialize(init_method=f"file://{store}", num_processes=world, process_id=rank,
               local_rank=rank, device=device)
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(fn, world: int, args=(), *, device="cpu", timeout: float = 600.0):
    """Run `fn(rank, world, *args)` in `world` spawned processes that form one
    torch.distributed world over a file store (gloo for device "cpu", one
    thread per rank; NCCL with one card per rank for "cuda"); returns the
    ranks' results in rank
    order.  `fn` must be importable (a module-level function) and its
    result picklable.  A rank that raises makes this raise (the others are
    terminated); a world still running after `timeout` seconds is killed
    and raises TimeoutError."""
    with tempfile.TemporaryDirectory(prefix="frenetix_world_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = torch.multiprocessing.start_processes(
            _world_rank, args=(fn, world, tuple(args), device, store, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {world} ranks ran past "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
