"""The readings the limits of a cell's correctness check are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--out FILE]

For each seed, in one process: the program's set-up and its checked
steps (or batches) as a benchmark run makes them, with no window; then
the reference; the numbers compared (the lower readings, from sound
runs).  For each control seed also the control (the reference computed
one precision below the configuration's, in the program's place) and,
for a training cell, the faults: half the batch left out (the reference
on half of each batch, the mean over the rest), the AAM weight's gradient
dropped, and the AAM weight or fc1 left unchanged: the upper readings.  One
JSON line per seed and kind on standard output and in ``--out``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import manifest
    from portbench.run import Ctx

    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in dict.fromkeys(args.seeds + args.control_seeds):
            ctx = Ctx(cell.name, cell.config, cell.traffic, seed, 0.0, False, dev, cell.limits)
            for row in cell.driver.calibrate(ctx, seed in args.control_seeds):
                row.update(cell=cell.name, seed=seed, t=time.time())
                line = json.dumps(row)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
