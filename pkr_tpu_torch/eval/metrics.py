"""EER and minDCF — bit-for-bit the reference implementations.

Own copy of ``pkr_tpu/eval/metrics.py``'s numpy code (the port imports
nothing of ``pkr_tpu``):
- scripts/compute_eer.py — cumulative fnr/fpr sweep over stably sorted
  scores, EER = max(fpr, fnr) at argmin |fnr - fpr|;
- local/compute_min_dcf.py — NIST DCF
  min_t (c_miss·fnr·p + c_fa·fpr·(1-p)) / min(c_miss·p, c_fa·(1-p)),
  first-minimum threshold.
Float64 accumulators, so the arithmetic matches python floats exactly.
``python -m pkr_tpu_torch.eval.metrics [--p-target P] <scores> <trials>``
prints what scripts/compute_eer.py / local/compute_min_dcf.py print.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def compute_error_rates(scores: Sequence[float], labels: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted-threshold fnr/fpr curves.

    At threshold index i (scores sorted ascending, stable),
    fnr[i] = (# targets with score <= threshold_i) / (# targets) and
    fpr[i] = 1 - (# nontargets with score <= threshold_i) / (# nontargets).
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    n_tgt = int(labels.sum())
    if n_tgt == 0 or n_tgt == len(labels):
        raise ValueError(
            f"trials contain {n_tgt} target / {len(labels) - n_tgt} "
            "nontarget pairs — EER/minDCF need at least one of each")
    order = np.argsort(scores, kind="stable")
    thresholds = scores[order]
    sorted_labels = labels[order]
    n_target = sorted_labels.sum()
    n_nontarget = len(sorted_labels) - n_target
    fnrs = np.cumsum(sorted_labels) / n_target
    fprs = 1.0 - np.cumsum(1.0 - sorted_labels) / n_nontarget
    return fnrs, fprs, thresholds


def _eer(fnrs: np.ndarray, fprs: np.ndarray) -> float:
    i = int(np.nanargmin(np.absolute(fnrs - fprs)))
    return float(max(fprs[i], fnrs[i]))


def _min_dcf(fnrs: np.ndarray, fprs: np.ndarray, thresholds: np.ndarray,
             p_target: float, c_miss: float, c_fa: float) -> Tuple[float, float]:
    c_det = c_miss * fnrs * p_target + c_fa * fprs * (1.0 - p_target)
    i = int(np.argmin(c_det))  # np.argmin returns the first minimum
    c_def = min(c_miss * p_target, c_fa * (1.0 - p_target))
    return float(c_det[i] / c_def), float(thresholds[i])


def compute_eer(scores: Sequence[float], labels: Sequence[int]) -> float:
    return _eer(*compute_error_rates(scores, labels)[:2])


def compute_min_dcf(scores: Sequence[float], labels: Sequence[int],
                    p_target: float = 0.01, c_miss: float = 1.0,
                    c_fa: float = 1.0) -> Tuple[float, float]:
    """Returns (min_dcf, threshold_at_min); the first minimum wins, like the
    reference's strict '<' scan."""
    return _min_dcf(*compute_error_rates(scores, labels), p_target, c_miss, c_fa)


def compute_eer_min_dcf(scores: Sequence[float], labels: Sequence[int],
                        p_target: float = 0.01) -> Tuple[float, float]:
    """(compute_eer, compute_min_dcf's min_dcf) from one sweep of the error
    rates: the same values as the two calls, for half the sorting."""
    fnrs, fprs, thresholds = compute_error_rates(scores, labels)
    return _eer(fnrs, fprs), _min_dcf(fnrs, fprs, thresholds, p_target, 1.0, 1.0)[0]


def scores_and_labels_from_files(score_path: str, trials_path: str
                                 ) -> Tuple[List[float], List[int]]:
    """Join a '<utt1> <utt2> <score>' file against a
    '<utt1> <utt2> target|nontarget' trials file (compute_eer.py:72-97
    semantics: every score line must have a trial entry)."""
    trials: Dict[str, str] = {}
    for line in open(trials_path):
        u1, u2, t = line.split()
        trials[u1 + " " + u2] = t
    scores, labels = [], []
    for line in open(score_path):
        u1, u2, s = line.split()
        key = u1 + " " + u2
        if key not in trials:
            raise KeyError(f"Missing trial entry for {key}")
        scores.append(float(s))
        labels.append(1 if trials[key] == "target" else 0)
    return scores, labels


def _cli(argv=None):
    """CLI parity with scripts/compute_eer.py / local/compute_min_dcf.py:
    `python -m pkr_tpu_torch.eval.metrics [--p-target P] <scores> <trials>`."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="EER / minDCF from score+trial files")
    ap.add_argument("--p-target", type=float, default=None,
                    help="report minDCF at this prior instead of EER")
    ap.add_argument("--c-miss", type=float, default=1.0)
    ap.add_argument("--c-fa", type=float, default=1.0)
    ap.add_argument("scores")
    ap.add_argument("trials")
    args = ap.parse_args(argv)
    scores, labels = scores_and_labels_from_files(args.scores, args.trials)
    if args.p_target is None:
        eer = compute_eer(scores, labels)
        sys.stdout.write(f"{eer:.2%}\n")
    else:
        mindcf, thr = compute_min_dcf(scores, labels, args.p_target,
                                      args.c_miss, args.c_fa)
        sys.stdout.write(f"{mindcf:.4f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
