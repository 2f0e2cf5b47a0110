"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and window
seconds from the profiler's trace.  Either way the run compares what the
timed path produced with the plain reference, prints each number compared
beside its limit as the last lines of standard error and under ``checks``,
the last key of the line, and sets ``correct``.

It exits non-zero and prints no result when there is no CUDA device or
fewer than the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or
``pkr_tpu`` has been loaded by the time the window closes.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # before any import of weight: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pkr_tpu")


@dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments and the
    moment set-up began."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    limits: dict
    t0: float = T_PROCESS
    hooks: dict = field(default_factory=dict)
    marks: list = field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note how far into set-up a phase of it ended (printed to stderr)."""
        self.marks.append((name, time.perf_counter() - self.t0))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``pkr_tpu_torch`` is not ``pkr_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(cell, out: dict, trace: bool, device_info: dict) -> dict:
    from portbench import manifest

    if trace:
        metrics = manifest.read_layer_metrics(cell.per_layer, out["records"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": _finite(float(v)), "unit": units[k]}
                   for k, v in out["e2e"].items() if k in units}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = {name: {"value": _finite(value), "limit": limit}
                      for name, value, limit in out["checks"]}
    return line


def _finite(x: float) -> float:
    """A reading as strict JSON can carry it: one that is not finite (an
    answer that never came, a NaN) becomes the largest double."""
    return x if math.isfinite(x) else 1.7976931348623157e308


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell of pkr_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import manifest

    bench = manifest.load_json(ROOT / "BENCHMARK.json")
    cell = manifest.resolve(bench, args.workload)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ctx = Ctx(cell.name, cell.config, cell.traffic, args.seed, args.seconds, bool(args.trace),
              dev, cell.limits)
    out = cell.driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device_info["busy_s"] = out["busy_s"]
        device_info["window_s"] = out["window_s"]
    line = result_line(cell, out, bool(args.trace), device_info)
    print("set-up phases (s since start): " + ", ".join(f"{n} {t:.2f}" for n, t in ctx.marks),
          file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
