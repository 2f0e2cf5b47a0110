"""Every name in BENCHMARK.json leads to its file, and keeps the
benchmark's character rules for names, units and text."""

import json
import re

import pytest

from portbench import manifest

ROOT = manifest.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH_RE.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = manifest.resolve(BENCH, cell)
    assert c.chips in (1, 4)
    assert hasattr(c.driver, "run") and hasattr(c.driver, "calibrate")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(manifest.readers(c.per_layer)) == {m["name"] for m in c.per_layer}
    assert c.limits.get("checks"), "every cell's comparison has its limits"


def test_configs_and_files():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert manifest.config_path(c["name"]) == ROOT / c["file"]
        assert len(c["reduced"]) <= 16


def test_names_units_and_keys():
    every = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(manifest.NAME_RE.match(n) for n in every), every
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for m in metrics:
        assert manifest.UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"], set()).add(m["name"])
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_run_seconds_fit_twelve_hours():
    """24 cells of 14 runs each, a minute and two compiles a cell of
    slack, fit in 12 hours."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
