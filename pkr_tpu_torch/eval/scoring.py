"""Trial scoring: centering, cosine, cohort S-norm statistics, trial files.

Port of ``pkr_tpu/eval/scoring.py``.  Parity targets of the reference:
- scripts/compute_mean.py:10-21 (global mean),
- scripts/compute_speaker_mean.py / compute_mean_byspk.py (cohort and
  pooled enrollment means),
- scripts/cosine_score.py:37-69 (mean-subtracted cosine per trial),
- scripts/compute_topk_mean_std.py:10-23 (center, L2-normalize, cosine vs
  cohort, top-300 mean/std — std is torch's UNBIASED default),
- scripts/adaptive_snorm.py:33-34 (s' = ((s-μe)/σe + (s-μt)/σt)/2 with
  σ floored at 1e-8).

Dictionaries of numpy embeddings in, numpy scores out.  The two products —
enroll × test cosines and the (N, D) × (D, C) cohort cosines with their
top-k — run as full-f32 ``torch.matmul`` and ``torch.topk`` on the device;
the rest is host numpy, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, full_f32, resolve_device


def global_mean(vecs: Dict[str, np.ndarray]) -> np.ndarray:
    mat = np.stack(list(vecs.values())).astype(np.float32)
    return mat.mean(axis=0)


def speaker_means(vecs: Dict[str, np.ndarray], utt2spk: Dict[str, str]
                  ) -> Dict[str, np.ndarray]:
    groups: Dict[str, List[np.ndarray]] = {}
    for utt, v in vecs.items():
        groups.setdefault(utt2spk[utt], []).append(v)
    return {s: np.mean(g, axis=0).astype(np.float32) for s, g in groups.items()}


def pooled_speaker_means(vecs: Dict[str, np.ndarray],
                         spk2utt: Dict[str, Sequence[str]]) -> Dict[str, np.ndarray]:
    """Enrollment pooling via spk2utt lists (compute_mean_byspk.py:9-41)."""
    out = {}
    for spk, utts in spk2utt.items():
        mats = [vecs[u] for u in utts if u in vecs]
        if mats:
            out[spk] = np.mean(mats, axis=0).astype(np.float32)
    return out


def _normalize_rows(mat: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    return mat / np.maximum(norms, eps)


def cosine_scores(enroll: Dict[str, np.ndarray], test: Dict[str, np.ndarray],
                  trials: Sequence[Tuple[str, str]],
                  mean: Optional[np.ndarray] = None,
                  device: DeviceLike = None) -> np.ndarray:
    """Scores for (enroll_key, test_key) trial pairs, mean-centered cosine.

    Dense trial sets (≳1/4 of the full cross) take one normalized
    enroll×test matmul; sparse ones take a row-gathered pairwise dot, so the
    full matrix is never built where it would not fit."""
    dev = resolve_device(device)
    e_keys = list(enroll)
    t_keys = list(test)
    e_idx = {k: i for i, k in enumerate(e_keys)}
    t_idx = {k: i for i, k in enumerate(t_keys)}
    e = np.stack([enroll[k] for k in e_keys]).astype(np.float32)
    t = np.stack([test[k] for k in t_keys]).astype(np.float32)
    if mean is not None:
        e = e - mean
        t = t - mean
    e = torch.from_numpy(_normalize_rows(e)).to(dev)
    t = torch.from_numpy(_normalize_rows(t)).to(dev)
    rows = torch.from_numpy(np.fromiter((e_idx[a] for a, _ in trials), np.int64,
                                        len(trials))).to(dev)
    cols = torch.from_numpy(np.fromiter((t_idx[b] for _, b in trials), np.int64,
                                        len(trials))).to(dev)
    if len(trials) * 4 >= len(e_keys) * len(t_keys):
        with full_f32():
            scores = torch.matmul(e, t.T)
        return scores[rows, cols].cpu().numpy()
    return torch.sum(e[rows] * t[cols], dim=1).cpu().numpy()


def cohort_topk_stats(vecs: Dict[str, np.ndarray], cohort: np.ndarray,
                      topk: int = 300, mean: Optional[np.ndarray] = None,
                      device: DeviceLike = None
                      ) -> Dict[str, Tuple[float, float]]:
    """Per-key (mean, std) of the top-k cosines against the cohort matrix.

    Centering by `mean` is applied to both sides; std is unbiased
    (compute_topk_mean_std.py:19 uses torch.std_mean's default).  The
    cosines and their top-k are formed on the device in row chunks that
    bound the (chunk, C) block; the statistics come back in float64."""
    dev = resolve_device(device)
    keys = list(vecs)
    mat = np.stack([vecs[k] for k in keys]).astype(np.float32)
    coh = cohort.astype(np.float32)
    if mean is not None:
        mat = mat - mean
        coh = coh - mean
    mat = torch.from_numpy(_normalize_rows(mat)).to(dev)
    coh_t = torch.from_numpy(np.ascontiguousarray(_normalize_rows(coh).T)).to(dev)
    k = min(topk, coh.shape[0])
    # chunk rows so the (N, C) score block stays bounded (N can be 145k utts)
    chunk = max(1, (1 << 27) // max(coh.shape[0], 1))
    mu = np.empty(len(keys), np.float64)
    sd = np.empty(len(keys), np.float64)
    for lo in range(0, len(keys), chunk):
        with full_f32():
            scores = torch.matmul(mat[lo:lo + chunk], coh_t)
        part = torch.topk(scores, k, dim=1).values.to(torch.float64)
        mu[lo:lo + chunk] = part.mean(dim=1).cpu().numpy()
        sd[lo:lo + chunk] = part.std(dim=1, correction=1).cpu().numpy()
    return {key: (float(mu[i]), float(sd[i])) for i, key in enumerate(keys)}


def adaptive_snorm(scores: np.ndarray, trials: Sequence[Tuple[str, str]],
                   enroll_stats: Dict[str, Tuple[float, float]],
                   test_stats: Dict[str, Tuple[float, float]]) -> np.ndarray:
    """Adaptive S-norm (adaptive_snorm.py:33-34)."""
    mu_e = np.fromiter((enroll_stats[a][0] for a, _ in trials), np.float64, len(trials))
    sd_e = np.fromiter((enroll_stats[a][1] for a, _ in trials), np.float64, len(trials))
    mu_t = np.fromiter((test_stats[b][0] for _, b in trials), np.float64, len(trials))
    sd_t = np.fromiter((test_stats[b][1] for _, b in trials), np.float64, len(trials))
    s = np.asarray(scores, np.float64)
    return ((s - mu_e) / np.maximum(sd_e, 1e-8) / 2
            + (s - mu_t) / np.maximum(sd_t, 1e-8) / 2)


def read_trials(path: str) -> Tuple[List[Tuple[str, str]], List[int]]:
    """'<enroll> <test> target|nontarget' → (pairs, 0/1 labels).

    Labeled and unlabeled lines must not mix: a partially-labeled file
    would silently misalign labels[i] with pairs[i] for every line after
    the first unlabeled one (raise instead).  A fully unlabeled file (a
    pairs-only scoring list) returns labels == []."""
    pairs, labels = [], []
    for ln, line in enumerate(open(path), 1):
        parts = line.split()
        if not parts:
            continue
        a, b = parts[0], parts[1]
        pairs.append((a, b))
        if len(parts) > 2:
            labels.append(1 if parts[2] == "target" else 0)
        elif labels:
            raise ValueError(
                f"{path}:{ln}: unlabeled trial after labeled ones — "
                "labels would misalign with pairs")
    if labels and len(labels) != len(pairs):
        raise ValueError(
            f"{path}: {len(pairs)} pairs but {len(labels)} labels "
            "(mixed labeled/unlabeled lines)")
    return pairs, labels


def write_scores(path: str, trials: Sequence[Tuple[str, str]],
                 scores: Sequence[float]) -> None:
    with open(path, "w") as f:
        for (a, b), s in zip(trials, scores):
            f.write(f"{a} {b} {float(s)}\n")
