"""Corpus-scale rehearsal: the recipe CLI's stages 0-6, over ~100k
utterances of 2,000 speakers on one card, with each stage's wall time and
peak device memory.

Port of ``tools/corpus_rehearsal.py``.  It exercises, at a scale where they
matter: full-corpus MUSAN pools on rotating device shards (and the
rotation record), the RIR-set reverb branch, the card-resident feature
cache for training, the flash head (a second stage-3 run over the same
features) and the cohort-subset extraction knob.  The corpus is the JAX
tool's: the same seeds give the same wav samples and manifests (the draws
in its order, the signals rendered on host threads).

Each stage is ``pkr_tpu_torch.recipes.run.main`` in this process; its time
goes to ``<out>/rehearsal_times.json`` as it ends, so ``--resume`` skips
what a cut run finished.  The peak device memory of a stage is
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` (None
on the CPU).  The summary, ``<out>/rehearsal_summary.json``, keeps the JAX
tool's keys (``times_s``, ``peak_hbm_gb`` here by stage, ``rotation``,
``results``) and adds the flash kernels' launches by route for each stage
run, the stage-1 and extraction rates, the cache and the ms/step of both
stage-3 runs, and the card's name and power limit.

Run: python -m pkr_tpu_torch.tools.corpus_rehearsal [--spk 2000] [--utt 25]
[--out DIR] [--device cpu]; the corpus takes ~7.5 GB of disk at the defaults.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device

RATE = 16000
# the stages whose work runs on the device (0 and 2 are file work)
DEVICE_STAGES = ("stage1", "stage3", "stage4", "stage5", "stage6", "stage3_flash")


def _render_utt(path: str, t: np.ndarray, env: np.ndarray, f0: float,
                noise: np.ndarray) -> None:
    """One utterance of synth_corpus, in the JAX tool's arithmetic."""
    from pkr_tpu_torch.io.wav import write_wav

    sig = np.zeros(len(t), np.float32)
    for h in range(len(env)):
        sig += env[h] * np.sin(2 * np.pi * f0 * (h + 1) * t).astype(np.float32)
    sig *= 6000.0
    sig += noise
    write_wav(path, sig, RATE)


def synth_corpus(root: str, spk_names: Sequence[str], n_utt: int, seed: int,
                 sec_lo: float = 3.2, sec_hi: float = 4.2):
    """Harmonic-envelope speaker identities (see recipe_demo): identity =
    fixed harmonic amplitudes, pitch drawn per utterance.  The draws come in
    the JAX tool's order from one ``np.random.default_rng(seed)``; the
    signals are rendered and written on a thread a core."""
    from pkr_tpu_torch.io import DataDir

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    utt2spk, wav = {}, {}
    n_harm = 10
    t_max = np.arange(int(sec_hi * RATE)) / RATE
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        jobs = []
        for spk in spk_names:
            env = rng.uniform(0.2, 1.0, n_harm)
            env /= env.sum()
            for j in range(n_utt):
                n = int(rng.uniform(sec_lo, sec_hi) * RATE)
                f0 = rng.uniform(95.0, 240.0)
                noise = rng.normal(0, 250.0, n).astype(np.float32)
                u = f"{spk}-u{j:03d}"
                p = os.path.join(root, f"{u}.wav")
                jobs.append(pool.submit(_render_utt, p, t_max[:n], env, f0, noise))
                utt2spk[u] = spk
                wav[u] = p
            if len(jobs) >= 256:  # bound the noise draws held in memory
                for job in jobs:
                    job.result()
                jobs = []
        for job in jobs:
            job.result()
    return DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()


def synth_musan(root: str, n_noise: int = 120, n_music: int = 60, n_speech: int = 90,
                sec: float = 8.0, seed: int = 1) -> str:
    """MUSAN-layout tree (musan/{noise,music,speech}/sub0/*.wav) sized so the
    byte-budgeted pool shards rotate during stage 1."""
    from pkr_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(sec * RATE)) / RATE
    for kind, k in (("noise", n_noise), ("music", n_music), ("speech", n_speech)):
        d = os.path.join(root, kind, "sub0")
        os.makedirs(d, exist_ok=True)
        for i in range(k):
            if kind == "noise":
                w = rng.normal(0, 1500, len(t))
            elif kind == "music":
                w = 2000 * np.sin(2 * np.pi * rng.uniform(200, 800) * t)
                w += 800 * np.sin(2 * np.pi * rng.uniform(50, 200) * t)
            else:
                w = 1500 * np.sin(2 * np.pi * rng.uniform(90, 250) * t)
                w *= (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
            write_wav(os.path.join(d, f"{kind}{i:04d}.wav"), w.astype(np.float32), RATE)
    return root


def synth_rir_tree(root: str, seed: int = 2) -> str:
    """A RIRS_NOISES-style tree: two simulated room sets of 8 RIRs over two
    rooms each, with their rir_list files (paths relative to root's parent)."""
    from pkr_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(seed)
    base = os.path.basename(root.rstrip("/"))
    for room_set, n_rirs, delay in (("smallroom", 8, 40), ("mediumroom", 8, 160)):
        d = os.path.join(root, "simulated_rirs", room_set)
        lines = []
        for r in range(2):
            os.makedirs(os.path.join(d, f"Room{r:03d}"), exist_ok=True)
            for i in range(n_rirs // 2):
                rel = f"{base}/simulated_rirs/{room_set}/Room{r:03d}/r{i}.wav"
                rir = np.zeros(1600, np.float32)
                rir[0] = 1.0
                rir[delay + 11 * i + 7 * r] = 0.5
                rir += (0.02 * rng.standard_normal(1600)
                        * np.exp(-np.arange(1600) / 400.0)).astype(np.float32)
                write_wav(os.path.join(root, "..", rel), rir * 8000, RATE)
                lines.append(f"--rir-id {room_set[:2]}{r}{i:03d} "
                             f"--room-id {room_set[:2]}-room{r} {rel}")
        with open(os.path.join(d, "rir_list"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def rehearsal_config(epochs: int = 2, *, trunk: str = "resnet34", batch_size: int = 256,
                     cohort_subset: int = 10000, print_freq: int = 100):
    """The JAX tool's Config: AAM on the default trunk, B = 256 from the
    device cache, S-norm scoring over a 10,000-utterance cohort subset,
    min_frames 150, a 2 % cv split, 8 MB pool shards rotating every 2,000
    rows."""
    from pkr_tpu_torch.config import Config

    d = Config()
    return Config(
        model=dataclasses.replace(d.model, loss="AAM", trunk=trunk),
        train=dataclasses.replace(d.train, epochs=epochs, batch_size=batch_size,
                                  device_cache=True, print_freq=print_freq),
        eval=dataclasses.replace(d.eval, backend="snorm", batch_size=64,
                                 cohort_subset=cohort_subset),
        data=dataclasses.replace(d.data, min_frames=150, cv_fraction=0.02,
                                 pool_shard_mb=8, pool_rotate_rows=2000))


def _launch_counts():
    """Each flash kernel's launches by route since the last reset (the
    routes it took only)."""
    from pkr_tpu_torch.ops import flash_aam as fa

    return {k: {r: n for r, n in getattr(fa, k).route_launches.items() if n}
            for k in ("flash_aam_fwd", "flash_aam_bwd")}


def _reset_launches():
    from pkr_tpu_torch.ops import flash_aam as fa

    for fn in (fa.flash_aam_fwd, fa.flash_aam_bwd):
        fn.launches = 0
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def train_speed(metrics_path: str, batch: int, print_freq: int) -> Optional[Dict]:
    """ms/step of a stage-3 run from its step records (one each print_freq
    steps, logged after a synchronize): the median window, the first one
    (the builds) left out; None where fewer than three records were logged."""
    if not os.path.exists(metrics_path):
        return None
    with open(metrics_path) as f:
        stamps = [r["t"] for r in map(json.loads, f) if "step" in r]
    windows = [1e3 * (b - a) / print_freq for a, b in zip(stamps[1:], stamps[2:])]
    if not windows:
        return None
    ms = float(np.median(windows))
    return {"ms_per_step": ms, "examples_per_s": batch * 1e3 / ms, "windows": len(windows)}


def _cache_record(lines, t_start):
    """The device cache's size (run_train's print) and the seconds from the
    stage's start to it (the model build and the cache build)."""
    for t, line in lines:
        m = re.match(r"device cache: ([0-9.]+) MB", line)
        if m:
            return {"mb": float(m.group(1)), "ready_s": t - t_start}
    return None


def _count_lines(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for _ in f)


def write_corpus(root: str, spk: int, utt: int, test_spk: int, test_utt: int) -> int:
    """The corpus, the disjoint test side, the 2x augmented train dir, the
    MUSAN and RIR trees and every pair of the test utterances as trials;
    returns the train rows."""
    from pkr_tpu_torch.recipes.augment_dir import augment_data_dir

    dd = synth_corpus(os.path.join(root, "wavs"), [f"s{i:04d}" for i in range(spk)], utt,
                      seed=0)
    tdd = synth_corpus(os.path.join(root, "wavs_test"),
                       [f"t{i:04d}" for i in range(test_spk)], test_utt, seed=10)
    tdd.save(os.path.join(root, "data_test"))
    # 2x corpus: every utterance gets one augmented copy (utt2aug)
    aug = augment_data_dir(dd, seed=0)
    aug.save(os.path.join(root, "data"))
    synth_musan(os.path.join(root, "musan"))
    synth_rir_tree(os.path.join(root, "RIRS_NOISES"))
    tu = sorted(tdd["utt2spk"])
    u2s = tdd["utt2spk"]
    with open(os.path.join(root, "trials"), "w") as f:
        for i, a in enumerate(tu):
            for b in tu[i + 1:]:
                f.write(f"{a} {b} {'target' if u2s[a] == u2s[b] else 'nontarget'}\n")
    return len(aug["utt2spk"])


def rehearse(root: str, *, spk: int = 2000, utt: int = 25, test_spk: int = 200,
             test_utt: int = 4, epochs: int = 2, skip_synth: bool = False,
             resume: bool = False, synth_only: bool = False, trunk: str = "resnet34",
             batch_size: int = 256, cohort_subset: int = 10000, print_freq: int = 100,
             device: DeviceLike = None) -> Optional[Dict]:
    """The rehearsal under ``root``; returns the summary (None with
    ``synth_only``).  Raises without a card unless ``device="cpu"``, before
    writing anything."""
    from pkr_tpu_torch.recipes.run import main as run_main
    from pkr_tpu_torch.tools.bigspk import _Tee, card_line

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    data, test_data = os.path.join(root, "data"), os.path.join(root, "data_test")
    trials = os.path.join(root, "trials")
    os.makedirs(root, exist_ok=True)
    times_path = os.path.join(root, "rehearsal_times.json")
    times: Dict[str, float] = {}
    if resume and os.path.exists(times_path):
        with open(times_path) as f:
            times = json.load(f)
        print(f"resume: {sorted(times)} already done")

    def record(key, dt):
        times[key] = dt
        with open(times_path + ".tmp", "w") as f:
            json.dump(times, f)
        os.replace(times_path + ".tmp", times_path)

    if not skip_synth:
        t0 = time.perf_counter()
        n_rows = write_corpus(root, spk, utt, test_spk, test_utt)
        record("synth", time.perf_counter() - t0)
        print(f"corpus: {n_rows} train rows ({spk} spk), {test_spk * test_utt} test utts "
              f"({test_spk} spk)  [{times['synth']:.0f}s]")
    if synth_only:
        print("synth-only: corpus ready; rerun with --skip-synth for the device stages")
        return None

    cfg = rehearsal_config(epochs, trunk=trunk, batch_size=batch_size,
                           cohort_subset=cohort_subset, print_freq=print_freq)
    cfg_path = os.path.join(root, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    exp, exp_f = os.path.join(root, "exp"), os.path.join(root, "exp_flash")
    common = ["--config", cfg_path, "--data-dir", data, "--test-data-dir", test_data,
              "--trials", trials, "--exp-dir", exp, "--musan-dir",
              os.path.join(root, "musan"), "--rir-dir", os.path.join(root, "RIRS_NOISES"),
              "--device", str(dev)]
    # the flash-on train rerun: same features, its own exp dir
    cfg_f = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, flash_aam=True))
    cfgf_path = os.path.join(root, "cfg_flash.json")
    with open(cfgf_path, "w") as f:
        f.write(cfg_f.to_json())
    flash = ["--config", cfgf_path, "--data-dir", data, "--exp-dir", exp_f, "--stage", "3",
             "--stop-stage", "3", "--device", str(dev)]
    runs = [(f"stage{s}", common + ["--stage", str(s), "--stop-stage", str(s)])
            for s in range(7)] + [("stage3_flash", flash)]
    peaks: Dict[str, Optional[float]] = {}
    launches: Dict[str, dict] = {}
    caches: Dict[str, dict] = {}
    for key, argv in runs:
        if resume and key in times:
            print(f"  {key}: done in a previous attempt ({times[key]:.1f}s) — skipped")
            continue
        if key == "stage3_flash":
            os.makedirs(exp_f, exist_ok=True)
            if not os.path.exists(os.path.join(exp_f, "feats")):
                os.symlink(os.path.join(exp, "feats"), os.path.join(exp_f, "feats"))
        _reset_launches()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = run_main(argv)
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{key}: recipes.run.main returned {rc}")
        record(key, dt)
        peaks[key] = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        launches[key] = _launch_counts()
        if key in ("stage3", "stage3_flash"):
            caches[key] = _cache_record(tee.lines, t0)
        peak = "n/a" if peaks[key] is None else f"{peaks[key]:.2f}GB"
        print(f"  {key}: {dt:.1f}s  peak_hbm={peak}")

    rotation, results = "n/a", {}
    rot = os.path.join(exp, "feats", "stage1_metrics.jsonl")
    if os.path.exists(rot):
        with open(rot) as f:
            rotation = f.read().strip()
    res_path = os.path.join(exp, "results.json")
    if os.path.exists(res_path):
        with open(res_path) as f:
            results = json.load(f)
    n_rows = _count_lines(os.path.join(data, "utt2spk"))
    n_test = _count_lines(os.path.join(test_data, "utt2spk"))
    n_ext = _count_lines(os.path.join(exp, "train.iv")) + _count_lines(
        os.path.join(exp, "test.iv"))
    summary = {
        "times_s": {k: round(v, 1) for k, v in times.items()},
        "peak_hbm_gb": peaks,
        "rotation": rotation,
        "results": results,
        "rows": {"train": n_rows, "test": n_test, "extracted": n_ext,
                 "trials": _count_lines(trials)},
        "stage1_utts_per_s": ((n_rows + n_test) / times["stage1"]
                              if "stage1" in times else None),
        "extract_utts_per_s": n_ext / times["stage4"] if "stage4" in times else None,
        "cache": caches,
        "train": {key: train_speed(os.path.join(d, "train_metrics.jsonl"), batch_size,
                                   print_freq)
                  for key, d in (("stage3", exp), ("stage3_flash", exp_f))},
        "route_launches": launches,
        "device": str(dev),
        "card": card_line() if on_card else "cpu",
    }
    print(json.dumps(summary, indent=1))
    with open(os.path.join(root, "rehearsal_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spk", type=int, default=2000)
    ap.add_argument("--utt", type=int, default=25)
    ap.add_argument("--test-spk", type=int, default=200)
    ap.add_argument("--test-utt", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "pkr_rehearsal"))
    ap.add_argument("--skip-synth", action="store_true",
                    help="reuse an existing --out corpus")
    ap.add_argument("--resume", action="store_true",
                    help="skip stages already recorded in rehearsal_times.json")
    ap.add_argument("--synth-only", action="store_true",
                    help="build the corpus and exit before any device work")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    rehearse(args.out, spk=args.spk, utt=args.utt, test_spk=args.test_spk,
             test_utt=args.test_utt, epochs=args.epochs, skip_synth=args.skip_synth,
             resume=args.resume, synth_only=args.synth_only, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
