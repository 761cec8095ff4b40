"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its comparison limits (`limits/<config>.json`)
and its per-layer metrics' readers (`metrics/<name>.py`)."""
from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path=None) -> dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "configs" / f"{name}.json").read_text())


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metrics_of(bench: dict, workload: str, section: str) -> list[dict]:
    """The metrics of `section` that `workload` reports: those that list it,
    and those without a `workloads` key."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def bad_names(bench: dict) -> list[str]:
    """The names, keys and units that break the allowed characters."""
    bad = []
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += list(c["reduced"])
    bad += [n for n in names if not NAME.match(n)]
    bad += [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]
            if not UNIT.match(m["unit"])]
    return bad
