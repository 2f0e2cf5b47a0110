"""Stage-1 throughput: clean against augmented feature extraction on the card.

Port of ``tools/bench_stage1.py``.  The reference fans ``wav-reverberate`` /
MUSAN-mixing pipes over nj=30 CPU jobs (steps/data/augment_data_dir.py:71-118,
local/make_fbank.sh:118-126); the port mixes a whole bucket on the card
inside ``run_features``.  This measures the stage-1 utterances/s of a
clean corpus, of its augmented double (clean + one augmented copy an
utterance, every kind) and of an all-reverb copy through the RIR-set
planner (rooms, rir_list, point-source noises), each after a warm pass,
then sweeps the CM-encode worker count.  The corpus, pools and RIR tree are
the JAX tool's (the same seeds, the same samples).

Run: python -m pkr_tpu_torch.tools.bench_stage1 [--utts 96] [--sec 4.0]
[--out DIR] [--device cpu]; prints the JAX tool's lines, then one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device


def build_corpus(root: str, n_utts: int, sec: float, rate: int = 16000):
    """n_utts ragged 5-harmonic utterances of 8 speakers; saves the data dir
    at root/clean and returns (it, its path)."""
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(0)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    wav, utt2spk = {}, {}
    for i in range(n_utts):
        n = int(sec * rate) + int(rng.integers(0, rate))  # ragged lengths
        t = np.arange(n) / rate
        f0 = 90.0 + 30.0 * (i % 8)
        sig = np.zeros(n, np.float32)
        for h in range(1, 6):
            sig += np.sin(2 * np.pi * f0 * h * t).astype(np.float32) / h
        sig *= 6000.0 / np.abs(sig).max()
        utt = f"spk{i % 8:02d}-utt{i:04d}"
        path = os.path.join(wav_dir, utt + ".wav")
        write_wav(path, sig.astype(np.float32))
        wav[utt] = path
        utt2spk[utt] = f"spk{i % 8:02d}"
    dd = DataDir({"wav.scp": wav, "utt2spk": utt2spk}).make_spk2utt()
    clean = os.path.join(root, "clean")
    dd.save(clean)
    return dd, clean


def build_pools(rate: int = 16000, device: DeviceLike = None):
    """In-memory noise, music and speech pools of white noise and 8 RIRs,
    on ``device``."""
    from pkr_tpu_torch.recipes.augment_dir import AugmentPools

    rng = np.random.default_rng(1)

    def pool(k, sec):
        wavs = [rng.normal(0, 2000, int(sec * rate)).astype(np.float32) for _ in range(k)]
        return AugmentPools.from_wavs(wavs, int(sec * rate))

    rirs = [np.r_[np.zeros(64, np.float32), 1.0,
                  rng.normal(0, 0.05, 800).astype(np.float32) * np.exp(-np.arange(800) / 200.0)]
            for _ in range(8)]
    return AugmentPools(noise=pool(12, 4.0), music=pool(12, 6.0), speech=pool(16, 4.0),
                        rirs=AugmentPools.from_wavs(rirs, int(0.1 * rate)), device=device)


def build_rir_tree(root: str, rate: int = 16000):
    """A small RIRS_NOISES-style tree (two room sets of 6 RIRs with their
    rir_list, a foreground and a background point-source noise with their
    noise_list); returns (the tree, the noise_list path)."""
    from pkr_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(2)
    tree = os.path.join(root, "RIRS_NOISES")
    base = os.path.basename(tree)
    for room_set, n_rirs, delay in (("smallroom", 6, 40), ("mediumroom", 6, 160)):
        d = os.path.join(tree, "simulated_rirs", room_set)
        os.makedirs(os.path.join(d, "Room001"), exist_ok=True)
        lines = []
        for i in range(n_rirs):
            rel = f"{base}/simulated_rirs/{room_set}/Room001/r{i}.wav"
            rir = np.zeros(1600, np.float32)
            rir[0] = 1.0
            rir[delay + 13 * i] = 0.5
            rir += (0.02 * rng.standard_normal(1600) * np.exp(-np.arange(1600) / 400.0))
            write_wav(os.path.join(root, rel), (rir * 8000).astype(np.float32), rate)
            lines.append(f"--rir-id {room_set[:2]}{i:03d} "
                         f"--room-id {room_set[:2]}-room1 {rel}")
        with open(os.path.join(d, "rir_list"), "w") as f:
            f.write("\n".join(lines) + "\n")
    nd = os.path.join(tree, "pointsource_noises")
    os.makedirs(nd, exist_ok=True)
    lines = []
    for i, (bgfg, sec) in enumerate((("foreground", 1.0), ("background", 3.0))):
        rel = f"{base}/pointsource_noises/n{i}.wav"
        write_wav(os.path.join(root, rel),
                  rng.normal(0, 1500, int(sec * rate)).astype(np.float32), rate)
        lines.append(f"--noise-id n{i} --noise-type point-source "
                     f"--bg-fg-type {bgfg} {rel}")
    noise_list = os.path.join(nd, "noise_list")
    with open(noise_list, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tree, noise_list


def time_stage1(data_dir: str, out_dir: str, pools, n_utts: int, batch: int = 32,
                encode_workers: int = 1, device: DeviceLike = None) -> float:
    """run_features' wall seconds, the card synchronized before each clock
    read; checks that every utterance got features."""
    from pkr_tpu_torch.recipes.run import run_features

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    run_features(data_dir, out_dir, batch=batch, pools=pools,
                 encode_workers=encode_workers, device=dev)
    sync()
    dt = time.perf_counter() - t0
    n_written = sum(1 for _ in open(os.path.join(out_dir, "feats.scp")))
    if n_written != n_utts:
        raise RuntimeError(f"{out_dir}: {n_written} utterances with features of {n_utts}")
    return dt


def run_bench(root: str, utts: int = 96, sec: float = 4.0,
              encode_workers: Sequence[int] = (1, 2), device: DeviceLike = None) -> Dict:
    """The three rows and the worker sweep under ``root``; returns
    {"rows": {tag: {"utts", "s", "utts_per_s"}}, "encode_workers": [...]}.
    Raises without a card unless ``device="cpu"``, before writing anything."""
    from pkr_tpu_torch.recipes.augment_dir import augment_data_dir

    dev = resolve_device(device)
    dd, clean_dir = build_corpus(root, utts, sec)
    aug = augment_data_dir(dd, seed=0)
    aug_dir = os.path.join(root, "aug")
    aug.save(aug_dir)
    pools = build_pools(device=dev)

    # rir row: all-reverb augmented dir through the RIR-set machinery
    # (parse → planner → composed reverb+noise), the run.sh:93-130 branch
    rvb = augment_data_dir(dd, kinds=("reverb",), seed=1)
    rvb_dir = os.path.join(root, "rvb")
    rvb.save(rvb_dir)
    tree, noise_list = build_rir_tree(root)
    rir_pools = build_pools(device=dev).attach_rir_set(
        tree, noise_set_params=[noise_list], foreground_snrs=(15.0, 10.0),
        background_snrs=(20.0,), max_noises_per_minute=30.0)

    cases = (("clean", clean_dir, utts, None), ("aug", aug_dir, 2 * utts, pools),
             ("rir", rvb_dir, 2 * utts, rir_pools))
    # a warm pass builds every bucket shape's kernels; the second is timed
    for tag, ddir, n, p in cases:
        time_stage1(ddir, os.path.join(root, f"feat_{tag}_warm"), p, n, device=dev)
    rows = {}
    for tag, ddir, n, p in cases:
        s = time_stage1(ddir, os.path.join(root, f"feat_{tag}"), p, n, device=dev)
        rows[tag] = {"utts": n, "s": s, "utts_per_s": n / s}
    sweep = []
    for w in encode_workers:
        s = time_stage1(clean_dir, os.path.join(root, f"feat_ew{w}"), None, utts,
                        encode_workers=w, device=dev)
        sweep.append({"workers": w, "s": s, "utts_per_s": utts / s})
    return {"rows": rows, "encode_workers": sweep}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--utts", type=int, default=96)
    ap.add_argument("--sec", type=float, default=4.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "pkr_stage1_bench"))
    ap.add_argument("--encode-workers", type=int, nargs="+", default=(1, 2),
                    help="sweep of CM-encode worker counts (per-shard arks)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    from pkr_tpu_torch.tools.bigspk import card_line

    dev = resolve_device(args.device)
    out = run_bench(args.out, args.utts, args.sec, args.encode_workers, device=dev)
    rows = out["rows"]
    r_clean = rows["clean"]["utts_per_s"]
    c, a, r = rows["clean"], rows["aug"], rows["rir"]
    print(f"clean: {c['utts']} utts in {c['s']:.2f}s = {r_clean:.1f} utts/s")
    print(f"aug:   {a['utts']} utts in {a['s']:.2f}s = {a['utts_per_s']:.1f} utts/s"
          f"  (x{r_clean / a['utts_per_s']:.2f} slower per utt)")
    print(f"rir:   {r['utts']} utts in {r['s']:.2f}s = {r['utts_per_s']:.1f} utts/s"
          f"  (RIR-set reverb + fg/bg noises; x{r_clean / r['utts_per_s']:.2f} "
          "slower per utt)")
    for w in out["encode_workers"]:
        print(f"encode_workers={w['workers']}: {args.utts} utts in {w['s']:.2f}s = "
              f"{w['utts_per_s']:.1f} utts/s  (cores={os.cpu_count()})")
    print(json.dumps({"bench_stage1": out, "cores": os.cpu_count(), "device": str(dev),
                      "card": card_line() if dev.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
