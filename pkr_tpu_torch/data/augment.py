"""Waveform augmentation: speed perturbation.

A numpy copy of ``speed_perturb`` from ``pkr_tpu/data/augment.py``, which
stage 1 of the recipe applies to a data dir's ``utt2speed`` entries.  The
additive-noise, music, babble and RIR branches of that module (and the
``AugmentPools`` that feed them) are not ported yet.
"""

from __future__ import annotations

import numpy as np


def speed_perturb(signal: np.ndarray, factor: float) -> np.ndarray:
    """sox speed semantics: playback-rate change (resample, new length
    n/factor) by linear interpolation.  Host-side numpy: this runs once per
    utterance as it is decoded."""
    n = len(signal)
    new_n = int(round(n / factor))
    pos = np.arange(new_n) * factor
    i0 = np.clip(pos.astype(np.int64), 0, n - 1)
    i1 = np.clip(i0 + 1, 0, n - 1)
    frac = (pos - i0).astype(signal.dtype)
    return signal[i0] * (1 - frac) + signal[i1] * frac
