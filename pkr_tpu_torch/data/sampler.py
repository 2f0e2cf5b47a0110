"""Class-balanced training samplers.

A copy of ``pkr_tpu/data/sampler.py`` for the port, which imports nothing
of ``pkr_tpu``.

Replicates the reference's two balancing strategies (SURVEY.md §2.2) as
index-space samplers decoupled from I/O:

- `BalancedRepetitionSampler` — datasets.py:16-31 semantics: cap
  ``max_id_count = min(500, (max_class_count+1)//2)``; every utterance of a
  class with ``count`` examples enters the epoch list
  ``max(1, max_id_count // count)`` times.
- `SpeakerBalancedSampler` — datasets.py:74-146 ("--dataset v2"): an epoch is
  ``num_spk × repetition`` draws, speaker = index % num_spk (round-robin over
  the sorted label set), utterance uniform within the speaker;
  ``repetition = (max_class_count+1)//2``.

Determinism: all randomness comes from numpy Generators seeded with
(seed, epoch) — identical across hosts, unlike the reference's free-running
per-worker RNG (SURVEY §7 balanced-sampler determinism hard part).  Host
sharding takes every (process_index + k·process_count)-th element of the
globally-shuffled list — the DistributedSampler contract without the padding
duplicates that forced the reference's awk dedup (run_aam_v2.sh:131-136).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def load_utt2spkid(path: str) -> Dict[str, int]:
    out = {}
    for line in open(path):
        parts = line.split()
        if parts:
            out[parts[0]] = int(parts[1])
    return out


class BalancedRepetitionSampler:
    def __init__(self, utts: Sequence[str], labels: Sequence[int],
                 max_per_class: int = 500):
        labels = np.asarray(labels, np.int64)
        counts: Dict[int, int] = {}
        for l in labels:
            counts[int(l)] = counts.get(int(l), 0) + 1
        # empty split (a tiny corpus whose cv fraction rounds to zero):
        # yield zero batches instead of crashing in max()
        cap = min(max_per_class,
                  (max(counts.values()) + 1) // 2) if counts else 0
        idx: List[int] = []
        for i, l in enumerate(labels):
            idx.extend([i] * max(1, cap // counts[int(l)]))
        self.utts = list(utts)
        self.labels = labels
        self.index = np.asarray(idx, np.int64)
        self.max_id_count = cap

    def __len__(self) -> int:
        return len(self.index)

    def epoch_indices(self, epoch: int, seed: int = 0,
                      process_index: int = 0, process_count: int = 1) -> np.ndarray:
        """Shuffled, host-sharded utterance indices for one epoch."""
        rng = np.random.default_rng((seed, epoch))
        order = rng.permutation(len(self.index))
        shuffled = self.index[order]
        # every host must see the SAME count or hosts disagree on
        # n_batches and the SPMD step deadlocks in the gradient all-reduce
        # (DistributedSampler solved this by padding; we truncate)
        per_host = len(shuffled) // process_count
        return shuffled[process_index::process_count][:per_host]


class SpeakerBalancedSampler:
    def __init__(self, utts: Sequence[str], labels: Sequence[int]):
        labels = np.asarray(labels, np.int64)
        self.utts = list(utts)
        self.labels = labels
        self.by_spk: Dict[int, np.ndarray] = {}
        for i, l in enumerate(labels):
            self.by_spk.setdefault(int(l), []).append(i)
        self.by_spk = {k: np.asarray(v, np.int64) for k, v in self.by_spk.items()}
        self.spk_list = np.asarray(sorted(self.by_spk), np.int64)
        counts = [len(v) for v in self.by_spk.values()]
        self.repetition = (max(counts) + 1) // 2 if counts else 0

    @property
    def num_spk(self) -> int:
        return len(self.spk_list)

    def __len__(self) -> int:
        return self.num_spk * self.repetition

    def epoch_indices(self, epoch: int, seed: int = 0,
                      process_index: int = 0, process_count: int = 1) -> np.ndarray:
        rng = np.random.default_rng((seed, epoch, 1))
        n = len(self)
        spk = self.spk_list[np.arange(n) % self.num_spk]
        # one uniform utterance draw per slot
        idx = np.empty(n, np.int64)
        for s in self.spk_list:
            slots = np.nonzero(spk == s)[0]
            pool = self.by_spk[int(s)]
            idx[slots] = pool[rng.integers(0, len(pool), len(slots))]
        order = rng.permutation(n)
        per_host = n // process_count  # equal per-host counts (see above)
        return idx[order][process_index::process_count][:per_host]
