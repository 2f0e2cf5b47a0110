"""Large speaker counts through the train CLI's own path.

Port of ``tools/bigspk_demo.py``: drives ``recipes.run.run_train`` (what
``python -m pkr_tpu_torch.recipes.run --stage 3`` runs) with the flash head
and the card-resident feature cache at 7325 and 500,000 synthetic speakers,
and reports the steady ms/step of each.  Then, unless ``--skip-mesh``, the
same function with ``model_parallel = 2`` and the flash head over two gloo
ranks on the CPU (the class-sharded head composed with the data axis).

The corpus is fake (random CM-compressed features with random labels): the
subject is the classifier's scaling, not convergence.  At 500,000 speakers
the AAM weight is 512 MB in f32 and its gradient and momentum another 1 GB.

Run: python -m pkr_tpu_torch.tools.bigspk [--speakers N ...] [--skip-mesh]
Prints a markdown table with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from pkr_tpu_torch.device import DeviceLike, resolve_device

N_TRAIN, N_CV, FRAMES, FDIM = 768, 64, 220, 40


def make_featdir(root: str, n_spk: int, seed: int = 0) -> str:
    """A feature dir of N_TRAIN train and N_CV cv utterances of FRAMES × FDIM
    standard normals with uniform labels over ``n_spk`` speakers: per split
    the labels, then one matrix per utterance, all from one
    ``np.random.default_rng(seed)`` (the same draws, in the same order, as
    ``tools/bigspk_demo.py``)."""
    from pkr_tpu_torch.io import write_ark_scp

    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, f"feats_{n_spk}")
    for split, n in (("train", N_TRAIN), ("cv", N_CV)):
        d = os.path.join(feat_dir, split)
        os.makedirs(d, exist_ok=True)
        labels = rng.integers(0, n_spk, n)
        with write_ark_scp(os.path.join(d, "feats.ark"),
                           os.path.join(d, "feats.scp"), compress=True) as w, \
                open(os.path.join(d, "utt2spkid"), "w") as u:
            for i in range(n):
                utt = f"{split}{i:05d}"
                w.write(utt, rng.standard_normal((FRAMES, FDIM)).astype(np.float32))
                u.write(f"{utt} {labels[i]}\n")
    with open(os.path.join(feat_dir, "num_spk"), "w") as f:
        f.write(str(n_spk))
    return feat_dir


class CliRun(NamedTuple):
    step_ms: float  # the last logged window's mean step, in ms
    wall_s: float  # run_train's wall time, builds and checkpoints included
    exp_dir: str  # train_metrics.jsonl and the checkpoints


class _Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy, and each whole line with the host
    time it was written at (``lines``, (time.perf_counter(), line))."""

    def __init__(self, out):
        self.out, self.buf, self.lines, self._part = out, io.StringIO(), [], ""

    def write(self, s):
        self.buf.write(s)
        self._part += s
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def train_config(epochs: int = 4, trunk: str = "resnet34", batch_size: int = 256,
                 chunk: int = 200, flash_aam: bool = True, print_freq: int = 3):
    """The demo's Config: ResNet-34, AAM, mean+std; B = 256 × 200-frame
    crops, the flash head on the device cache, 4 epochs, a window of 3
    steps, the last checkpoint kept."""
    from pkr_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(
        model=ModelConfig(trunk=trunk, loss="AAM", pooling="mean+std"),
        train=TrainConfig(epochs=epochs, batch_size=batch_size, chunk_size=(chunk,),
                          flash_aam=flash_aam, device_cache=True, print_freq=print_freq,
                          keep_last_checkpoints=1, seed=0))


def run_cli_train(n_spk: int, root: str, epochs: int = 4, *, trunk: str = "resnet34",
                  batch_size: int = 256, chunk: int = 200, flash_aam: bool = True,
                  print_freq: int = 3, device: DeviceLike = None) -> CliRun:
    """The stage-3 function on a fresh feature dir of ``n_spk`` speakers;
    the steady ms/step is the loop's ``time`` meter of the last window of
    the run (the first windows include the builds).  Raises where the run
    logged no window."""
    from pkr_tpu_torch.recipes.run import run_train

    dev = resolve_device(device)
    feat_dir = make_featdir(root, n_spk)
    exp_dir = os.path.join(root, f"exp_{n_spk}" + ("" if flash_aam else "_dense"))
    cfg = train_config(epochs, trunk, batch_size, chunk, flash_aam, print_freq)
    tee = _Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        run_train(cfg, feat_dir, exp_dir, device=dev)
    wall = time.time() - t0
    # the time meter prints "time <window mean> (<epoch mean>)" in seconds
    vals = re.findall(r"time ([0-9.]+) \(", tee.buf.getvalue())
    if not vals:
        raise RuntimeError("no 'time' meter lines captured: did the train loop's "
                           "progress format change, or print_freq exceed the steps "
                           "of an epoch?")
    return CliRun(float(vals[-1]) * 1000, wall, exp_dir)


def _mesh_rank(feat_dir: str, exp_dir: str) -> int:
    """One rank of cpu_mesh_demo (spawned, so at module level)."""
    from pkr_tpu_torch.parallel.distributed import process_count
    from pkr_tpu_torch.recipes.run import run_train

    cfg = train_config(epochs=1, trunk="tiny_resnet", batch_size=16, chunk=64)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, device_cache=False, model_parallel=2, print_freq=1000))
    run_train(cfg, feat_dir, exp_dir, device="cpu")
    return process_count()


def cpu_mesh_demo() -> str:
    """run_train with ``model_parallel = 2`` and the flash head over two gloo
    ranks on the CPU (the AAM weight's classes split over the model axis)."""
    from pkr_tpu_torch.parallel.distributed import spawn

    root = tempfile.mkdtemp(prefix="bigspk_mesh_")
    feat_dir = make_featdir(root, 1024)
    ranks = spawn(_mesh_rank, 2, args=(feat_dir, os.path.join(root, "exp")), device="cpu")
    return f"mesh-train OK ranks= {ranks[0]}"


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, or why there is none."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"no nvidia-smi ({exc.__class__.__name__})"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def table(rows: Sequence[tuple], card: str) -> List[str]:
    lines = ["| speakers | flash-AAM train step (B=256, CLI, device cache) | card |",
             "|---|---|---|"]
    for n_spk, step_ms, _ in rows:
        lines.append(f"| {n_spk:,} | {step_ms:.1f} ms ({256 / step_ms * 1000:.0f} ex/s) "
                     f"| {card} |")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    def positive(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError(f"speaker count must be >= 1: {v}")
        return n

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speakers", type=positive, nargs="+", default=[7325, 500_000])
    ap.add_argument("--skip-mesh", action="store_true")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    root = tempfile.mkdtemp(prefix="bigspk_")
    card = card_line() if dev.type == "cuda" else "cpu"
    rows = []
    for n_spk in args.speakers:
        run = run_cli_train(n_spk, root, device=dev)
        rows.append((n_spk, run.step_ms, run.wall_s))
        print(f"== {n_spk} speakers: {run.step_ms:.1f} ms/step "
              f"(wall {run.wall_s:.0f}s incl. builds)")
    if not args.skip_mesh:
        print(cpu_mesh_demo())
    print()
    print("\n".join(table(rows, card)))
    print(json.dumps({"bigspk": [{"speakers": n, "ms_per_step": ms, "wall_s": w}
                                 for n, ms, w in rows], "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
