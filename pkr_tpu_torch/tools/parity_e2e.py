"""End-to-end quality of the port against the banked EER and minDCF rows.

Port of the engine half of ``tools/parity_e2e.py`` (its ``run_once`` pilot
path, which trains ``pkr_tpu`` alone), with the port in ``pkr_tpu``'s
place.  Per seed: a synthetic corpus of 512 speakers × 8 two-second
utterances (the last 4 held out), fbank features through stage 1
(``recipes.run.run_features``), the reference's two-phase recipe
(run_aam_v2.sh stages 7-8) on one precomputed batch schedule — softmax
pretraining (BN+ReLU+Linear head) for 10 epochs, then the AAM head (m=0.2,
s=30) for 5, warm-started from the softmax trunk and fc1 with a fresh AAM
weight, SGD momentum 0.9 / wd 5e-4, a per-epoch cosine LR from 0.1 — then
the held-out embeddings scored on every enroll × test pair (786,432 trials)
with bootstrap confidence intervals.  The seed draws the corpus, the
schedule and the initial weights.

Corpus, features and schedule are the JAX tool's numpy draws, so a seed
gives the same data as the rows banked in ``docs/parity_rows.jsonl``
(``pkr_tpu``'s columns ``eer_p``/``dcf1_p``, the reference torch engine's
``eer_t``/``dcf1_t``); the initial weights are the port's own draw.  The
table sets each seed beside its banked row and gives the paired cross-seed
gaps (port − pkr_tpu, port − torch) as mean ± 2·SE.

Run: python -m pkr_tpu_torch.tools.parity_e2e --seeds 14 [--seed-start S]
Rows go to <root>/parity_rows.jsonl, the table to --out (default
<root>/parity_e2e.md); --root defaults to a new temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BANKED = os.path.join(REPO, "docs", "parity_rows.jsonl")
TRUNKS = ("tiny_resnet", "resnet34")
# the initial weights: the port's own draw (SpeakerModel's init from the
# seed), or the banked rows' (PyTorch's default module init in the
# reference transcription's order, torch_default_init)
INITS = ("port", "torch_default")


@dataclasses.dataclass(frozen=True)
class StudyConfig:
    """The corpus and training configuration of one seed."""

    n_spk: int = 512
    n_utt: int = 8  # per speaker; the last n_eval held out
    n_eval: int = 4
    seconds: float = 2.0
    rate: int = 16000
    crop: int = 100  # training crop (frames)
    batch: int = 64
    epochs: int = 5  # AAM fine-tune epochs (phase 2)
    epochs_softmax: int = 10  # softmax pretrain epochs (phase 1)
    lr0: float = 0.1
    seed: int = 0
    trunk: str = "resnet34"
    noise: float = 500.0  # additive noise floor (peak signal is 3000)
    amp_j: float = 0.25  # within-speaker harmonic amplitude jitter (1 ± amp_j)
    init: str = "port"  # one of INITS


def _render(path: str, t: np.ndarray, k: np.ndarray, f0: float, amps: np.ndarray,
            phases: np.ndarray, noise: np.ndarray, rate: int) -> None:
    from pkr_tpu_torch.io.wav import write_wav

    sig = (amps[None, :] * np.sin(
        2 * np.pi * f0 * k[None, :] * t[:, None] + phases)).sum(axis=1)
    sig = 3000 * sig / np.abs(sig).max()
    sig += noise
    write_wav(path, sig, rate)


def synth_corpus(root: str, cfg: StudyConfig) -> Tuple[List[str], Dict[str, str]]:
    """Hundreds of distinguishable synthetic speakers: each a point in a
    timbre space (f0 and a 12-harmonic amplitude envelope with a spectral
    tilt), each utterance with f0 and amplitude jitter, random phases and a
    strong noise floor.  The draws come in the JAX tool's order from one
    ``np.random.default_rng(cfg.seed)``; the signals are rendered and
    written on a thread a core.  A ``.done`` stamp with the same
    corpus parameters reuses the directory; other parameters re-synthesize
    it and drop its feature directory (``data_`` → ``feats_``)."""
    from pkr_tpu_torch.io import DataDir

    done = os.path.join(root, ".done")
    params = dict(seed=cfg.seed, n_spk=cfg.n_spk, n_utt=cfg.n_utt, seconds=cfg.seconds,
                  noise=cfg.noise, amp_j=cfg.amp_j)
    if os.path.exists(done):
        with open(done) as f:
            cached = json.load(f)
        if cached.get("params") == params:
            utt2spk = cached["utt2spk"]
            return sorted(utt2spk), utt2spk
        print(f"corpus cache params changed ({cached.get('params')} -> {params}): "
              f"re-synthesizing {root}", flush=True)
        shutil.rmtree(os.path.join(os.path.dirname(root),
                                   os.path.basename(root).replace("data_", "feats_")),
                      ignore_errors=True)
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(root, exist_ok=True)
    n = int(cfg.seconds * cfg.rate)
    t = np.arange(n) / cfg.rate
    utt2spk, wav = {}, {}
    n_harm = 12
    k = np.arange(1, n_harm + 1)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        jobs = []
        for i in range(cfg.n_spk):
            f0_s = rng.uniform(90.0, 280.0)
            amps_s = rng.uniform(0.05, 1.0, size=n_harm)
            tilt_s = rng.uniform(-0.6, 0.2)
            env_s = amps_s * (k ** tilt_s)
            for j in range(cfg.n_utt):
                f0 = f0_s * rng.uniform(0.97, 1.03)
                amps = env_s * rng.uniform(1 - cfg.amp_j, 1 + cfg.amp_j, size=n_harm)
                phases = rng.uniform(0, 2 * np.pi, size=n_harm)
                noise = cfg.noise * rng.standard_normal(n)
                utt = f"spk{i:03d}-utt{j:02d}"
                path = os.path.join(root, f"{utt}.wav")
                jobs.append(pool.submit(_render, path, t, k, f0, amps, phases, noise,
                                        cfg.rate))
                utt2spk[utt] = f"spk{i:03d}"
                wav[utt] = path
            if len(jobs) >= 256:  # bound the noise draws held in memory
                for job in jobs:
                    job.result()
                jobs = []
        for job in jobs:
            job.result()
    DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt().save(root)
    with open(done, "w") as f:
        json.dump({"params": params, "utt2spk": utt2spk}, f)
    return sorted(utt2spk), utt2spk


def load_features(data_dir: str, feat_dir: str, device: DeviceLike = None
                  ) -> Dict[str, np.ndarray]:
    """Stage 1 on the corpus (batch 32, no dither), kept under ``feat_dir``
    and reused where it holds every utterance."""
    from pkr_tpu_torch.io import read_mat_scp
    from pkr_tpu_torch.recipes.run import run_features

    scp = os.path.join(feat_dir, "feats.scp")
    with open(os.path.join(data_dir, "utt2spk")) as f:
        want = {line.split()[0] for line in f}
    if os.path.exists(scp):
        feats = dict(read_mat_scp(scp))
        if set(feats) >= want:
            return feats
        # a killed extraction leaves a partial ark behind a valid scp
        print(f"feature cache incomplete ({len(feats)}/{len(want)} utts): "
              f"re-extracting {feat_dir}", flush=True)
        shutil.rmtree(feat_dir)
    run_features(data_dir, feat_dir, batch=32, dither=0.0, device=device)
    return dict(read_mat_scp(scp))


def build_schedule(feats, train_utts, spk_ids, rng, epochs: int, cfg: StudyConfig):
    """The batches of ``epochs`` epochs: (steps, B, 40, crop) crops, (steps,
    B) labels and the steps an epoch, drawn from ``rng`` as the JAX tool
    draws them."""
    steps_per_epoch = max(1, len(train_utts) // cfg.batch)
    xs, ys = [], []
    for _ in range(epochs):
        order = rng.permutation(len(train_utts))
        for s in range(steps_per_epoch):
            rows, labs = [], []
            for kk in order[s * cfg.batch:(s + 1) * cfg.batch]:
                utt = train_utts[kk]
                f = feats[utt]  # (T, 40)
                start = rng.integers(0, max(f.shape[0] - cfg.crop, 1))
                rows.append(f[start:start + cfg.crop].T)  # (40, crop)
                labs.append(spk_ids[utt])
            xs.append(np.stack(rows).astype(np.float32))
            ys.append(np.asarray(labs, np.int64))
    return np.stack(xs), np.stack(ys), steps_per_epoch


def cosine_lr(spe: int, epochs: int, lr0: float, lr_final: float = 0.0) -> np.ndarray:
    """Per-step lr of a per-epoch cosine (CosineAnnealingLR stepped once an
    epoch, train_resnet.py:206)."""
    return np.concatenate([
        np.full(spe, lr_final + 0.5 * (lr0 - lr_final) * (1 + np.cos(np.pi * e / epochs)))
        for e in range(epochs)])


def new_model(loss: str, n_spk: int, cfg: StudyConfig, device: DeviceLike = None):
    """A phase's SpeakerModel at f32, its weights drawn from the seed."""
    from pkr_tpu_torch.models import SpeakerModel

    return SpeakerModel(spk_num=n_spk, feat_dim=40, trunk=cfg.trunk, pooling="mean+std",
                        loss=loss, dtype=torch.float32, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))


@torch.no_grad()
def torch_default_init(softmax_model, aam_model, seed: int) -> None:
    """The banked rows' initial weights, in place on CPU models: PyTorch's
    default init of each module (kaiming_uniform(a=√5) weights, uniform
    biases of bound 1/√fan_in, BatchNorm at 1 and 0) in the reference
    transcription's construction order (trunk, fc1, the softmax head's bn1
    and last), then the AAM weight as ``torch.randn``, all from one
    generator seeded by ``seed`` — what ``tools/parity_e2e.py`` draws after
    ``torch.manual_seed(seed)`` for its torch half and imports into
    ``pkr_tpu``.  ResNet trunks of BasicBlocks, as the study's."""
    from torch import nn

    from pkr_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator().manual_seed(seed)
    for mod in softmax_model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=g)
            if mod.bias is not None:
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                nn.init.uniform_(mod.bias, -bound, bound, generator=g)
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    aam_model.last.weight.copy_(torch.randn(aam_model.last.weight.shape, generator=g))


def precision_probe(model) -> Dict[str, Optional[bool]]:
    """Whether TF32 was allowed when the model's first convolution and fc1
    ran (filled by forward hooks, the last call's)."""
    seen: Dict[str, Optional[bool]] = {"conv_tf32": None, "matmul_tf32": None}

    def conv_hook(*_):
        seen["conv_tf32"] = bool(torch.backends.cudnn.allow_tf32)

    def matmul_hook(*_):
        seen["matmul_tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)

    model.res.conv1.register_forward_hook(conv_hook)
    model.fc1.register_forward_hook(matmul_hook)
    return seen


def run_phase(model, xs, ys, lrs, tag: str, device: DeviceLike = None) -> float:
    """SGD over the schedule's steps at their lr, from zero momentum (the
    dense head); returns the phase's seconds."""
    from pkr_tpu_torch.train import create_train_state, make_train_step

    dev = resolve_device(device)
    step = make_train_step(model, device=dev)
    state = create_train_state(model)
    t0 = time.time()
    for i in range(len(xs)):
        state, metrics = step(state, xs[i], ys[i], float(lrs[i]))
    loss = float(metrics["loss"])
    dt = time.time() - t0
    print(f"pkr_tpu_torch[{tag}]: {len(xs)} steps in {dt:.1f}s, final loss {loss:.3f}, "
          f"final acc1 {float(metrics['acc1']):.3f}", flush=True)
    return dt


@torch.no_grad()
def jiggle(model, eps: float, rng: np.random.Generator) -> None:
    """Every parameter times (1 + eps·N(0, 1)), in named_parameters order."""
    for _, p in model.named_parameters():
        noise = torch.from_numpy(rng.standard_normal(tuple(p.shape))).to(p)
        p.mul_(1.0 + eps * noise)


def train_two_phase(xs1, ys1, lr1, xs2, ys2, lr2, n_spk: int, cfg: StudyConfig,
                    device: DeviceLike = None, init=None, eps: float = 0.0,
                    precision: Optional[Dict] = None):
    """Softmax pretraining, then the AAM head warm-started from it by
    ``pkr_tpu`` variable path (``train.warm_start``): trunk, fc1 and their
    BatchNorm statistics carry over, the AAM weight stays the fresh draw.
    ``cfg.init`` draws the phases' initial weights (INITS); ``init`` =
    (softmax state dict, AAM state dict) replaces them; ``eps`` jiggles
    phase 1's (chaos_calibration);
    ``precision`` collects what the convolutions and matmuls ran in.
    Returns (the AAM model, seconds)."""
    from pkr_tpu_torch.train import warm_start

    dev = resolve_device(device)
    if cfg.init not in INITS:
        raise ValueError(f"unknown init {cfg.init!r} (choose from {INITS})")
    on = "cpu" if cfg.init == "torch_default" else dev  # drawn on a CPU generator
    m1 = new_model("softmax", n_spk, cfg, on)
    m2 = new_model("AAM", n_spk, cfg, on)
    if cfg.init == "torch_default":
        torch_default_init(m1, m2, cfg.seed)
        m1.to(dev)
        m2.to(dev)
    if init is not None:
        m1.load_state_dict(init[0], strict=True)
        m2.load_state_dict(init[1], strict=True)
    if eps:
        jiggle(m1, eps, np.random.default_rng(12345))  # the same direction per eps
    if precision is not None:
        seen = precision_probe(m1)
    dt = run_phase(m1, xs1, ys1, lr1, "softmax", dev)
    if precision is not None:
        precision.update(seen)
    warm_start(m1.state_dict(), m1.loss, m1.trunk, m2, verbose=False)
    del m1
    dt += run_phase(m2, xs2, ys2, lr2, "aam", dev)
    return m2, dt


@torch.no_grad()
def eval_embeddings(model, feats, utts: Sequence[str], batch: int = 256,
                    device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Embeddings of the full-length features, in eval mode."""
    dev = resolve_device(device)
    model.eval()
    out = {}
    for c in range(0, len(utts), batch):
        chunk = utts[c:c + batch]
        x = torch.from_numpy(np.stack([feats[u].T for u in chunk]).astype(np.float32))
        out.update(zip(chunk, model.embed(x.to(dev)).cpu().numpy()))
    return out


def score(embs, eval_utts, utt2spk, cfg: StudyConfig, device: DeviceLike = None):
    """Cosine scores of every (enroll, test) pair of held-out utterances
    (the first held-out utterance of a speaker enrolls it) → (scores,
    labels, EER, minDCF(.01), minDCF(.001))."""
    from pkr_tpu_torch.eval import compute_eer, compute_min_dcf, cosine_scores

    enroll, test = {}, {}
    first_eval = cfg.n_utt - cfg.n_eval
    for u in eval_utts:
        is_enroll = int(u.split("utt")[1]) == first_eval
        (enroll if is_enroll else test)[u] = embs[u]
    trials, labels = [], []
    for e in enroll:
        for t in test:
            trials.append((e, t))
            labels.append(1 if utt2spk[e] == utt2spk[t] else 0)
    scores = cosine_scores(enroll, test, trials, device=device)
    eer = compute_eer(scores.tolist(), labels)
    dcf1, _ = compute_min_dcf(scores.tolist(), labels, p_target=0.01)
    dcf2, _ = compute_min_dcf(scores.tolist(), labels, p_target=0.001)
    return np.asarray(scores), np.asarray(labels), eer, dcf1, dcf2


def bootstrap_metrics(scores, labels, n: int = 500, seed: int = 1):
    """Joint bootstrap CIs (2.5, 50, 97.5 percentiles) of EER and
    minDCF(0.01) over ``n`` trial resamples: the JAX tool's resamples, drawn
    in order from ``np.random.default_rng(seed)``, each scored on a thread
    of a pool of one a core."""
    from pkr_tpu_torch.eval.metrics import compute_eer_min_dcf

    rng = np.random.default_rng(seed)
    scores, labels = np.asarray(scores), np.asarray(labels)
    m = len(scores)

    def one(idx):
        return compute_eer_min_dcf(scores[idx].astype(np.float64), labels[idx])

    jobs = []
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for _ in range(n):
            idx = rng.integers(0, m, m)
            if labels[idx].min() == labels[idx].max():  # degenerate resample
                idx = np.arange(m)
            jobs.append(pool.submit(one, idx))
        res = np.asarray([j.result() for j in jobs]).reshape(n, 2)
    return (np.percentile(res[:, 0], [2.5, 50, 97.5]),
            np.percentile(res[:, 1], [2.5, 50, 97.5]))


def _corpus(root: str, cfg: StudyConfig, device, seconds: Dict[str, float]):
    """The seed's corpus, features and splits."""
    t0 = time.time()
    data_dir = os.path.join(root, f"data_s{cfg.seed}")
    utts, utt2spk = synth_corpus(data_dir, cfg)
    seconds["synthesis"] = time.time() - t0
    t0 = time.time()
    feats = load_features(data_dir, os.path.join(root, f"feats_s{cfg.seed}"), device)
    seconds["features"] = time.time() - t0
    spks = sorted(set(utt2spk.values()))
    spk_idx = {s: i for i, s in enumerate(spks)}
    spk_ids = {u: spk_idx[s] for u, s in utt2spk.items()}
    first_eval = cfg.n_utt - cfg.n_eval
    train_utts = [u for u in utts if int(u.split("utt")[1]) < first_eval]
    eval_utts = [u for u in utts if int(u.split("utt")[1]) >= first_eval]
    return feats, utt2spk, spk_ids, train_utts, eval_utts


def run_once(root: str, cfg: StudyConfig, device: DeviceLike = None, n_boot: int = 500
             ) -> Dict:
    """One seed of the study (``cfg.seed`` draws corpus, schedule and
    weights) → its row: EER, minDCF(.01) and (.001), their bootstrap CIs,
    the trial counts and the seconds of each part."""
    dev = resolve_device(device)
    seconds: Dict[str, float] = {}
    feats, utt2spk, spk_ids, train_utts, eval_utts = _corpus(root, cfg, dev, seconds)
    rng = np.random.default_rng(cfg.seed)
    # run_aam_v2.sh stages 7-8: softmax pretraining (cosine to 0), then the
    # AAM fine-tune (cosine 0.1 → 0)
    xs1, ys1, spe = build_schedule(feats, train_utts, spk_ids, rng, cfg.epochs_softmax, cfg)
    xs2, ys2, _ = build_schedule(feats, train_utts, spk_ids, rng, cfg.epochs, cfg)
    lr1 = cosine_lr(spe, cfg.epochs_softmax, cfg.lr0)
    lr2 = cosine_lr(spe, cfg.epochs, cfg.lr0)
    print(f"seed {cfg.seed}: {len(train_utts)} train / {len(eval_utts)} eval utts, "
          f"{len(xs1)}+{len(xs2)} steps (softmax+AAM)", flush=True)
    precision: Dict = {}
    t0 = time.time()
    model, t_train = train_two_phase(xs1, ys1, lr1, xs2, ys2, lr2, cfg.n_spk, cfg, dev,
                                     precision=precision)
    seconds["training"] = time.time() - t0
    t0 = time.time()
    emb = eval_embeddings(model, feats, eval_utts, device=dev)
    s, lab, eer, dcf1, dcf2 = score(emb, eval_utts, utt2spk, cfg, dev)
    seconds["scoring"] = time.time() - t0
    t0 = time.time()
    ci, dci = bootstrap_metrics(s, lab, n=n_boot)
    seconds["bootstrap"] = time.time() - t0
    print(f"seed {cfg.seed} ({cfg.init} init): EER {eer:.4f}  minDCF(.01) {dcf1:.4f}  "
          f"minDCF(.001) {dcf2:.4f}  ({len(s)} trials, {int(lab.sum())} target)", flush=True)
    return dict(seed=cfg.seed, init=cfg.init, n_trials=len(s), n_target=int(lab.sum()),
                eer=eer, dcf1=dcf1, dcf2=dcf2, ci=ci, dci=dci, n_boot=n_boot,
                t_train=t_train, steps=len(xs1) + len(xs2), seconds=seconds,
                precision=precision, device=str(dev))


def chaos_calibration(root: str, cfg: StudyConfig, device: DeviceLike = None) -> List[tuple]:
    """The same recipe on one seed with phase 1's initial weights times (1 +
    eps·N(0, 1)) for a ladder of eps, the schedule otherwise the same: the
    eps at which EER and minDCF move by the observed engine gaps says
    whether those gaps are float-level trajectory divergence.  Returns
    (eps, EER, minDCF(.01), minDCF(.001), mean max|Δemb|) rows."""
    dev = resolve_device(device)
    feats, utt2spk, spk_ids, train_utts, eval_utts = _corpus(root, cfg, dev, {})
    rng = np.random.default_rng(cfg.seed)
    xs1, ys1, spe = build_schedule(feats, train_utts, spk_ids, rng, cfg.epochs_softmax, cfg)
    xs2, ys2, _ = build_schedule(feats, train_utts, spk_ids, rng, cfg.epochs, cfg)
    lr1 = cosine_lr(spe, cfg.epochs_softmax, cfg.lr0)
    lr2 = cosine_lr(spe, cfg.epochs, cfg.lr0)
    rows, emb0 = [], None
    for eps in (0.0, 1e-7, 1e-6, 1e-5, 1e-4):
        tag = f"eps{eps:.0e}" if eps else "baseline"
        model, _ = train_two_phase(xs1, ys1, lr1, xs2, ys2, lr2, cfg.n_spk, cfg, dev,
                                   eps=eps)
        emb = eval_embeddings(model, feats, eval_utts, device=dev)
        _, _, eer, dcf1, dcf2 = score(emb, eval_utts, utt2spk, cfg, dev)
        if emb0 is None:
            emb0, demb = emb, 0.0
        else:
            demb = float(np.mean([np.max(np.abs(emb[u] - emb0[u])) for u in eval_utts]))
        print(f"chaos[{tag}]: EER {eer:.4f}  minDCF(.01) {dcf1:.4f}  minDCF(.001) "
              f"{dcf2:.4f}  mean-max|demb| {demb:.2e}", flush=True)
        rows.append((eps, eer, dcf1, dcf2, demb))
    base = rows[0]
    print(f"CHAOS CALIBRATION seed {cfg.seed} (same engine, init x(1+eps*N(0,1)), "
          f"{len(xs1) + len(xs2)} steps):", flush=True)
    for eps, eer, dcf1, dcf2, demb in rows[1:]:
        print(f"  eps={eps:.0e}: |dEER| {abs(eer - base[1]):.4f}  |dminDCF(.01)| "
              f"{abs(dcf1 - base[2]):.4f}  |dminDCF(.001)| {abs(dcf2 - base[3]):.4f}  "
              f"mean-max|demb| {demb:.2e}", flush=True)
    return rows


def load_banked(path: str = BANKED) -> Dict[int, Dict]:
    """The banked rows by seed (the file's last row of a seed wins)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no banked rows at {path}")
    by_seed = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                by_seed[r["seed"]] = r
    return by_seed


def banked_range(banked: Dict[int, Dict], key: str, k: float = 4.0) -> Tuple[float, float]:
    """mean ± k·sd (ddof 1) of both engines' banked values of ``key``
    (``eer`` or ``dcf1``: the ``_t`` and ``_p`` columns together)."""
    vals = np.asarray([r[f"{key}_{c}"] for r in banked.values() for c in ("t", "p")])
    mean, sd = float(vals.mean()), float(vals.std(ddof=1))
    return mean - k * sd, mean + k * sd


def banked_row(row: Dict, banked: Dict[int, Dict]) -> Optional[Dict]:
    """The banked row of ``row``'s seed where it was of the same study (the
    same trials and steps), else None."""
    b = banked.get(row["seed"])
    if b is None or (b["n_trials"], b["steps"]) != (row["n_trials"], row["steps"]):
        return None
    return b


def paired_gaps(rows: Sequence[Dict], banked: Dict[int, Dict]) -> Dict[str, Dict]:
    """Per banked engine ('pkr_tpu' = the ``_p`` column, 'torch' = ``_t``)
    and metric ('eer', 'dcf1'): the port − engine gaps over the seeds both
    have (``banked_row``), as {'n', 'mean', 'two_se'} (two_se None for one
    seed)."""
    common = [(r, banked_row(r, banked)) for r in rows if banked_row(r, banked)]
    out: Dict[str, Dict] = {}
    for engine, col in (("pkr_tpu", "p"), ("torch", "t")):
        out[engine] = {}
        for key in ("eer", "dcf1"):
            gaps = np.asarray([r[key] - b[f"{key}_{col}"] for r, b in common])
            n = len(gaps)
            out[engine][key] = {
                "n": n, "mean": float(gaps.mean()) if n else None,
                "two_se": float(2 * gaps.std(ddof=1) / np.sqrt(n)) if n > 1 else None}
    return out


def _pm(g: Dict) -> str:
    if g["mean"] is None:
        return "no seed in common"
    two_se = "n/a (one seed)" if g["two_se"] is None else f"{g['two_se']:.4f}"
    return f"{g['mean']:+.4f} ± {two_se}"


def _init_section(rows: Sequence[Dict], banked: Dict[int, Dict], init: str) -> List[str]:
    prec = rows[0].get("precision", {})
    lines = [
        f"## {init} init ({len(rows)} seed(s))",
        "",
        f"TF32 {'on' if prec.get('conv_tf32') else 'off'} in the convolutions, "
        f"{'on' if prec.get('matmul_tf32') else 'off'} in the matmuls.",
        "",
        "| seed | port EER [95% CI] | pkr_tpu EER | torch EER | port minDCF.01 [95% CI] "
        "| pkr_tpu minDCF.01 | torch minDCF.01 | port minDCF.001 | train s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]

    def bank(row, key):
        b = banked_row(row, banked)
        return "—" if b is None else f"{b[key]:.4f}"

    for r in rows:
        lines.append(
            f"| {r['seed']} | {r['eer']:.4f} [{r['ci'][0]:.4f}, {r['ci'][2]:.4f}] | "
            f"{bank(r, 'eer_p')} | {bank(r, 'eer_t')} | "
            f"{r['dcf1']:.4f} [{r['dci'][0]:.4f}, {r['dci'][2]:.4f}] | "
            f"{bank(r, 'dcf1_p')} | {bank(r, 'dcf1_t')} | "
            f"{r['dcf2']:.4f} | {r['t_train']:.1f} |")
    gaps = paired_gaps(rows, banked)
    eer = np.asarray([r["eer"] for r in rows])
    dcf = np.asarray([r["dcf1"] for r in rows])
    sd = (lambda a: f"{a.std(ddof=1):.4f}" if len(a) > 1 else "n/a")
    lines += [
        "",
        f"Port: mean EER {eer.mean():.4f} (sd {sd(eer)}), mean minDCF(.01) "
        f"{dcf.mean():.4f} (sd {sd(dcf)}).  Paired gaps, mean ± 2·SE over the "
        "seeds in common:",
        "",
        "| gap | n | EER | minDCF(.01) |",
        "|---|---|---|---|",
    ]
    for engine in ("pkr_tpu", "torch"):
        g = gaps[engine]
        lines.append(f"| port − {engine} | {g['eer']['n']} | {_pm(g['eer'])} | "
                     f"{_pm(g['dcf1'])} |")
    return lines + [""]


def write_table(rows: Sequence[Dict], banked: Dict[int, Dict], cfg: StudyConfig,
                out: str, card: str) -> str:
    """The study's markdown tables beside the banked rows, one for each
    init, with the paired gaps; written to ``out`` and returned."""
    lines = [
        "# parity_e2e — the port's end-to-end quality against the banked rows",
        "",
        f"`python -m pkr_tpu_torch.tools.parity_e2e` on {rows[0].get('device')} ({card}).",
        f"{cfg.n_spk} synthetic speakers × {cfg.n_utt - cfg.n_eval} train utterances "
        f"({cfg.seconds} s), {cfg.trunk} + mean+std at f32;",
        f"softmax {cfg.epochs_softmax} epochs then AAM {cfg.epochs} epochs, B = "
        f"{cfg.batch} × {cfg.crop} frames, cosine lr {cfg.lr0} → 0, SGD 0.9 / 5e-4.",
        "Banked: docs/parity_rows.jsonl (pkr_tpu `_p`, the reference torch engine "
        "`_t`), the same corpus and schedule per seed; their initial weights are "
        "the `torch_default` init's, not the `port` init's; — where the seed has "
        "no banked row of this study's trials and steps.",
        "",
    ]
    for init in INITS:
        of_init = [r for r in rows if r.get("init", "port") == init]
        if of_init:
            lines += _init_section(of_init, banked, init)
    doc = "\n".join(lines)
    with open(out, "w") as f:
        f.write(doc)
    return doc


def _load_rows(path: str) -> List[Dict]:
    by_key = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                by_key[(r.get("init", "port"), r["seed"])] = r  # the latest wins
    return [by_key[k] for k in sorted(by_key)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    d = StudyConfig()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent replicates (corpus+init+schedule)")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--spk", type=int, default=d.n_spk)
    ap.add_argument("--utt", type=int, default=d.n_utt)
    ap.add_argument("--epochs", type=int, default=d.epochs, help="AAM fine-tune epochs")
    ap.add_argument("--softmax-epochs", type=int, default=d.epochs_softmax)
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--crop", type=int, default=d.crop)
    ap.add_argument("--noise", type=float, default=d.noise)
    ap.add_argument("--amp-jitter", type=float, default=d.amp_j)
    ap.add_argument("--lr", type=float, default=d.lr0)
    ap.add_argument("--root", type=str, default=None,
                    help="corpus, feature and row directory (default: a new temporary one)")
    ap.add_argument("--trunk", type=str, default=d.trunk, choices=TRUNKS)
    ap.add_argument("--init", nargs="+", default=[d.init], choices=INITS,
                    help="the initial weights, each run on every seed: the port's own "
                         "draw, or the banked rows' (torch_default)")
    ap.add_argument("--chaos", action="store_true",
                    help="chaos calibration on the first seed and init: the recipe again "
                         "with phase 1's initial weights jiggled by a ladder of eps")
    ap.add_argument("--out", type=str, default=None,
                    help="the table (default: <root>/parity_e2e.md)")
    ap.add_argument("--banked", type=str, default=BANKED,
                    help="the banked rows to compare with")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    banked = load_banked(args.banked)
    cfg = StudyConfig(n_spk=args.spk, n_utt=args.utt, epochs=args.epochs,
                      epochs_softmax=args.softmax_epochs, batch=args.batch, crop=args.crop,
                      noise=args.noise, amp_j=args.amp_jitter, lr0=args.lr,
                      trunk=args.trunk, seed=args.seed_start, init=args.init[0])
    root = args.root or tempfile.mkdtemp(prefix="parity_e2e_")
    os.makedirs(root, exist_ok=True)
    out = args.out or os.path.join(root, "parity_e2e.md")
    if args.chaos:
        chaos_calibration(root, cfg, dev)
        return 0
    from pkr_tpu_torch.tools.bigspk import card_line

    card = card_line() if dev.type == "cuda" else "cpu"
    rows_path = os.path.join(root, "parity_rows.jsonl")
    for s in range(args.seed_start, args.seed_start + args.seeds):
        for init in args.init:  # the seed's corpus and features serve each init
            row = run_once(root, dataclasses.replace(cfg, seed=s, init=init), dev)
            row["card"] = card
            with open(rows_path, "a") as f:
                f.write(json.dumps({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                                    for k, v in row.items()}) + "\n")
            print(write_table(_load_rows(rows_path), banked, cfg, out, card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
