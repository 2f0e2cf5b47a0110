"""Enrollment/test splitting and utt-id normalization for private corpora.

A copy of ``pkr_tpu/recipes/enroll.py`` for the port.

Ports the "liveshow" production-eval tooling (SURVEY §2.1):
- scripts/format_utt.py — wav-path→label lists to wav.scp/utt2spk with
  zero-padded, collision-free keys;
- make_enroll_test.sh — N enroll / N test utterances per speaker;
- test_liveshow.sh's trial strategies are in pkr_tpu_torch.recipes.voxceleb
  (make_trials: rude/balance/part).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

from pkr_tpu_torch.io.datadir import DataDir


def format_utts(entries: Iterable[Tuple[str, str]], pad: int = 5) -> DataDir:
    """(wav_path, speaker_label) pairs → DataDir with normalized keys
    '<spk>-<seq>' (zero-padded per-speaker sequence, format_utt.py role)."""
    by_spk: Dict[str, List[str]] = {}
    norm_of: Dict[str, str] = {}
    for path, spk in entries:
        spk_norm = re.sub(r"[^A-Za-z0-9_]", "_", spk)
        prev = norm_of.setdefault(spk_norm, spk)
        if prev != spk:
            # 'spk.1' and 'spk_1' both normalize to 'spk_1': merging them
            # would silently mislabel every downstream trial
            raise ValueError(
                f"speaker labels {prev!r} and {spk!r} collide after "
                f"normalization ({spk_norm!r}); rename one")
        by_spk.setdefault(spk_norm, []).append(path)
    utt2spk, wav = {}, {}
    for spk, paths in sorted(by_spk.items()):
        for i, path in enumerate(sorted(paths)):
            utt = f"{spk}-{i:0{pad}d}"
            utt2spk[utt] = spk
            wav[utt] = path
    return DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()


def split_enroll_test(dd: DataDir, n_enroll: int, n_test: int,
                      seed: int = None) -> Tuple[DataDir, DataDir]:
    """Per-speaker first-N enroll / next-N test split (make_enroll_test.sh:
    15-38: sorted order, speakers lacking enough utts contribute what they
    have to enroll first).  Pass a seed to randomize the per-speaker order
    instead (NOT the reference behavior)."""
    import random

    rng = random.Random(seed) if seed is not None else None
    by_spk: Dict[str, List[str]] = {}
    for u, s in dd["utt2spk"].items():  # one O(U) grouping pass
        by_spk.setdefault(s, []).append(u)
    enroll_utts, test_utts = [], []
    for spk in sorted(by_spk):
        utts = sorted(by_spk[spk])
        if rng is not None:
            rng.shuffle(utts)
        enroll_utts.extend(utts[:n_enroll])
        test_utts.extend(utts[n_enroll:n_enroll + n_test])
    return dd.filter_utts(enroll_utts), dd.filter_utts(test_utts)
