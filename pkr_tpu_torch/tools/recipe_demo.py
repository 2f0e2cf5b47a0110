"""Moderate-scale recipe demo on the card: every stage through the Python
API, timed.

Port of ``tools/recipe_demo.py``: a disjoint-speaker eval set, a 2x
augmented train corpus mixed on the card from in-memory pools
(``AugmentPools.from_wavs``), training of the ResNet-34 r-vector from the
card-resident feature cache, extraction, adaptive S-norm scoring and
EER/minDCF, with each stage's wall time.  The corpus and the pools are the
JAX tool's: the same seeds give the same wav samples, manifests and pool
arrays (the draws in its order, the signals rendered on host threads).

Run: python -m pkr_tpu_torch.tools.recipe_demo [--train-spk 48] [--epochs 8]
[--device cpu]; prints the summary with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device

RATE = 16000


def _render_speaker_utt(path: str, n: int, envelope: np.ndarray, f0: float,
                        vib_hz: float, phases: Sequence[float], noise: np.ndarray) -> None:
    """One utterance of synth_speakers, in the JAX tool's arithmetic."""
    from pkr_tpu_torch.io.wav import write_wav

    t = np.arange(n) / RATE
    vib = 1.0 + 0.01 * np.sin(2 * np.pi * vib_hz * t)
    ks = [k for k in range(len(envelope)) if f0 * (k + 1) < 7000]
    sig = sum(envelope[k] * np.sin(2 * np.pi * f0 * (k + 1) * t * vib + ph)
              for k, ph in zip(ks, phases))
    sig = 3000 * sig / np.abs(sig).max()
    sig += noise
    write_wav(path, sig.astype(np.float32), RATE)


def synth_speakers(root: str, spk_names: Sequence[str], n_utt: int, seconds: float,
                   seed: int):
    """Speaker identity = a fixed harmonic-amplitude envelope (from the
    speaker name's crc32); pitch is drawn per utterance from a range shared
    by all speakers, so disjoint-speaker verification is an envelope-matching
    task.  The draws come in the JAX tool's order from one
    ``np.random.default_rng(seed)``; the signals are rendered and written on
    a thread a core.  Saves the data dir at root and returns it."""
    from pkr_tpu_torch.io import DataDir

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    utt2spk, wav = {}, {}
    n_harm = 12
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        jobs = []
        for spk in spk_names:
            srng = np.random.default_rng(zlib.crc32(spk.encode()))  # stable
            envelope = srng.uniform(0.05, 1.0, size=n_harm)  # the identity
            for j in range(n_utt):
                n = int(seconds * RATE) + int(rng.integers(0, RATE))
                f0 = rng.uniform(110.0, 220.0)  # shared pitch range
                vib_hz = rng.uniform(3, 7)
                phases = [rng.uniform(0, 6) for k in range(n_harm) if f0 * (k + 1) < 7000]
                noise = 300 * rng.standard_normal(n)
                utt = f"{spk}-utt{j:03d}"
                path = os.path.join(root, f"{utt}.wav")
                jobs.append(pool.submit(_render_speaker_utt, path, n, envelope, f0, vib_hz,
                                        phases, noise))
                utt2spk[utt] = spk
                wav[utt] = path
            if len(jobs) >= 256:  # bound the noise draws held in memory
                for job in jobs:
                    job.result()
                jobs = []
        for job in jobs:
            job.result()
    dd = DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()
    dd.save(root)
    return dd


def build_pools(seed: int = 1, device: DeviceLike = None):
    """In-memory noise, music and speech pools of white noise and 16 decaying
    RIRs, on ``device``."""
    from pkr_tpu_torch.recipes.augment_dir import AugmentPools

    rng = np.random.default_rng(seed)

    def pool(k, sec):
        return AugmentPools.from_wavs(
            [rng.normal(0, 1500, int(sec * RATE)).astype(np.float32) for _ in range(k)],
            int(sec * RATE))

    rirs = [np.r_[np.zeros(rng.integers(16, 128), np.float32), 1.0,
                  (rng.normal(0, 0.08, 1200)
                   * np.exp(-np.arange(1200) / 300.0)).astype(np.float32)]
            for _ in range(16)]
    return AugmentPools(noise=pool(24, 5.0), music=pool(24, 6.0), speech=pool(32, 4.0),
                        rirs=AugmentPools.from_wavs(rirs, int(0.12 * RATE)), device=device)


def demo_config(epochs: int = 8, batch: int = 64, trunk: str = "resnet34"):
    """ResNet-34, AAM, mean+std; B = 64 × 200-frame crops at lr 0.1 from the
    device cache; S-norm over the top 12, extraction buckets of 100 frames
    up to 700."""
    from pkr_tpu_torch.config import Config, EvalConfig, ModelConfig, TrainConfig

    return Config(
        model=ModelConfig(trunk=trunk, loss="AAM", pooling="mean+std"),
        train=TrainConfig(epochs=epochs, batch_size=batch, lr=0.1, chunk_size=(200,),
                          seed=0, print_freq=20, device_cache=True),
        eval=EvalConfig(backend="snorm", bucket_quantum=100, max_len=700, batch_size=32,
                        topk=12))


def run_demo(root: str, *, train_spk: int = 48, test_spk: int = 16, train_utt: int = 24,
             test_utt: int = 6, seconds: float = 3.0, epochs: int = 8, batch: int = 64,
             trunk: str = "resnet34", device: DeviceLike = None) -> Dict:
    """The demo under ``root`` (emptied first); returns {"stages": seconds by
    stage, "prep_s", "n_train", "num_spk", "results"}.  Raises without a
    card unless ``device="cpu"``, before writing anything."""
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.recipes import run as recipe
    from pkr_tpu_torch.recipes.augment_dir import augment_data_dir
    from pkr_tpu_torch.recipes.voxceleb import write_trials

    dev = resolve_device(device)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.time()

    shutil.rmtree(root, ignore_errors=True)
    train_spks = [f"spk{i:03d}" for i in range(train_spk)]
    test_spks = [f"spk{i:03d}" for i in range(train_spk, train_spk + test_spk)]
    t0 = time.time()
    train_dd = synth_speakers(os.path.join(root, "data/train"), train_spks, train_utt,
                              seconds, 0)
    test_dd = synth_speakers(os.path.join(root, "data/test"), test_spks, test_utt,
                             seconds, 1)
    # 2x augmented train corpus (run.sh:162-164 composition)
    aug = augment_data_dir(train_dd, seed=0)
    aug_dir = os.path.join(root, "data/train_aug")
    aug.save(aug_dir)
    # utt-utt trials (VoxCeleb style): utt000 of each test speaker enrolls,
    # the rest are test sides; full cross
    test_u2s = test_dd["utt2spk"]
    enr = sorted(u for u in test_u2s if u.endswith("utt000"))
    tst = sorted(u for u in test_u2s if not u.endswith("utt000"))
    trials = [(e, t, "target" if test_u2s[e] == test_u2s[t] else "nontarget")
              for e in enr for t in tst]
    trials_path = os.path.join(root, "data/test/trials")
    write_trials(trials_path, trials)
    t_prep = time.time() - t0

    cfg = demo_config(epochs, batch, trunk)
    exp = os.path.join(root, "exp")
    feat_dir = os.path.join(exp, "feats")
    test_feat_dir = os.path.join(exp, "feats_test")
    pools = build_pools(device=dev)

    stages = {}
    t0 = clock()
    recipe.run_features(aug_dir, feat_dir, pools=pools, seed=0, device=dev)
    recipe.run_features(os.path.join(root, "data/test"), test_feat_dir, seed=0, device=dev)
    stages["1 features (aug 2x + test)"] = clock() - t0

    t0 = clock()
    num_spk = recipe.run_split(feat_dir, aug_dir, min_frames=200, cv_fraction=0.05, seed=0)
    stages["2 split"] = clock() - t0

    t0 = clock()
    recipe.run_train(cfg, feat_dir, exp, device=dev)
    stages["3 train"] = clock() - t0

    t0 = clock()
    recipe.run_extract(cfg, feat_dir, exp, os.path.join(feat_dir, "train", "feats.scp"),
                       "train.iv", device=dev)
    recipe.run_extract(cfg, feat_dir, exp, os.path.join(test_feat_dir, "feats.scp"),
                       "test.iv", device=dev)
    stages["4 extract"] = clock() - t0

    t0 = clock()
    recipe.run_backend_stats(cfg, exp, aug_dir, device=dev)
    stages["5 backend stats"] = clock() - t0

    t0 = clock()
    cohort_u2s = DataDir.load(aug_dir, names=("utt2spk",))["utt2spk"]
    results = recipe.run_score(
        cfg, exp, trials_path, os.path.join(exp, "test.iv"), os.path.join(exp, "test.iv"),
        cohort_ark=os.path.join(exp, "train.iv"), cohort_utt2spk=cohort_u2s, device=dev)
    stages["6 score (snorm)"] = clock() - t0
    return {"stages": stages, "prep_s": t_prep, "n_train": aug.num_utts,
            "num_spk": num_spk, "n_trials": len(trials), "results": results}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-spk", type=int, default=48)
    ap.add_argument("--test-spk", type=int, default=16)
    ap.add_argument("--train-utt", type=int, default=24)
    ap.add_argument("--test-utt", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "pkr_recipe_demo"))
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    from pkr_tpu_torch.tools.bigspk import card_line

    dev = resolve_device(args.device)
    out = run_demo(args.root, train_spk=args.train_spk, test_spk=args.test_spk,
                   train_utt=args.train_utt, test_utt=args.test_utt, seconds=args.seconds,
                   epochs=args.epochs, batch=args.batch, device=dev)
    total = out["prep_s"] + sum(out["stages"].values())
    print("\n=== recipe_demo summary ===")
    print(f"corpus: {args.train_spk} train spk x {args.train_utt} utts x2 "
          f"augmented = {out['n_train']} train utts ({out['num_spk']} classes), "
          f"{args.test_spk} DISJOINT test spk x {args.test_utt} utts, "
          f"{args.seconds:.0f}-{args.seconds + 1:.0f}s each")
    print(f"model: ResNet-34 r-vector, AAM, device-cache training, "
          f"{args.epochs} epochs batch {args.batch}")
    for k, v in out["stages"].items():
        print(f"  stage {k}: {v:.1f}s")
    print(f"  host prep (wav synth + manifests): {out['prep_s']:.1f}s")
    print(f"  TOTAL: {total:.1f}s")
    print(f"results: {out['results']}")
    print(f"card: {card_line() if dev.type == 'cuda' else 'cpu'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
