"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a JSON file under this folder, found by its name.  The traffic file
names its driver.  The per-layer metrics that list a cell (or list none)
are read by ``layer_metrics/<name>.py``; the limits of the cell's
correctness check are ``limits/<cell>.json``.  Nothing here needs an edit
when a later change adds any of these.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file, by path: metric readers are named as their
    metrics, whose dots an import statement would take for packages."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_path(name: str, root: Path = HERE) -> Path:
    return root / "configs" / f"{name}.json"


def traffic_path(name: str, root: Path = HERE) -> Path:
    return root / "traffic" / f"{name}.json"


def driver_path(name: str, root: Path = HERE) -> Path:
    return root / "drivers" / f"{name}.py"


def reader_path(name: str, root: Path = HERE) -> Path:
    return root / "layer_metrics" / f"{name}.py"


def limits_path(cell: str, root: Path = HERE) -> Path:
    return root / "limits" / f"{cell}.json"


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, cell_name: str, root: Path = HERE) -> Cell:
    """The cell ``cell_name`` of ``manifest`` with every file it names
    loaded; raises KeyError or FileNotFoundError for a name that leads
    nowhere."""
    entries = [w for w in manifest["workloads"] if w["name"] == cell_name]
    if len(entries) != 1:
        raise KeyError(f"no single workload named {cell_name!r} in BENCHMARK.json")
    w = entries[0]
    configs = {c["name"]: c for c in manifest["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {cell_name!r} names no configuration {w['config']!r}")
    config = load_json(config_path(w["config"], root))
    traffic = load_json(traffic_path(w["traffic"], root))
    driver = load_module(driver_path(traffic["driver"], root),
                         f"portbench_driver_{traffic['driver']}")
    e2e = [m for m in manifest["end_to_end"] if reports(m, cell_name)]
    per_layer = [m for m in manifest["per_layer"] if reports(m, cell_name)]
    lp = limits_path(cell_name, root)
    limits = load_json(lp) if lp.exists() else {}
    return Cell(cell_name, int(w["chips"]), config, traffic, driver, e2e, per_layer, limits)


def readers(per_layer: List[dict], root: Path = HERE) -> Dict[str, ModuleType]:
    """The reader module of each per-layer metric, by the metric's name."""
    return {m["name"]: load_module(reader_path(m["name"], root),
                                   "portbench_reader_" + m["name"].replace(".", "_"))
            for m in per_layer}


def read_layer_metrics(per_layer: List[dict], records: dict,
                       root: Path = HERE) -> Dict[str, dict]:
    """Each per-layer metric whose reader finds something in ``records``:
    {name: {"value", "unit"}}.  A reader that finds nothing returns None,
    and its metric is left out."""
    out = {}
    for name, reader in readers(per_layer, root).items():
        value: Optional[float] = reader.read(records)
        if value is not None:
            unit = next(m["unit"] for m in per_layer if m["name"] == name)
            out[name] = {"value": float(value), "unit": unit}
    return out
