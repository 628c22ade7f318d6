"""Everything the harness reads by name: `BENCHMARK.json` at the root of the
checkout, and under `benchmark/` the configuration, traffic, kind, limit,
metric, roofline and reference files of a cell. Adding a cell, a
configuration, a mix, a traffic kind or a metric adds files and entries, and
edits none that is there."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None) -> dict:
    """-> {"workload", "config", "traffic", "end_to_end", "per_layer",
    "limits"} of the cell `name`: its entry, its configuration and traffic
    files, the metric entries that it reports, and its correctness limits."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    work = found[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    return {"workload": work,
            "config": load_json(ROOT / conf["file"]),
            "traffic": traffic(work["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
            "limits": limits(name)}


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    """{"checks": {number: limit}, "control": {...}}; empty where the
    cell has no limits file yet."""
    path = BENCH / "limits" / f"{cell_name}.json"
    return load_json(path) if path.exists() else {"checks": {}}


def module(kind: str, name: str):
    """The module `benchmark/<kind>/<name>.py` (names may hold dots)."""
    key = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The class `Kind` of `benchmark/kinds/<name>.py`: a traffic kind's pool,
    call, loop and reference (`harness/cell.py`)."""
    return module("kinds", name).Kind


def reference(cfg: dict):
    return module("reference", cfg["reference"])
