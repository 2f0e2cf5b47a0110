"""Training crops worked out from the cache's codes, as the recipe's
loader defines them.

- The epoch's order: each utterance of a class with ``count`` utterances
  enters ``max(1, cap // count)`` times, ``cap = min(max_per_class,
  (largest count + 1) // 2)``; the list is permuted by a NumPy generator
  seeded with (seed, epoch), and batch b takes the b-th run of B.
- A crop of ``T`` rows of utterance i at the uniform draw u starts at
  ``offset_i + trunc(u · max(rows_i − T + 1, 1))`` (formed in f32), row t
  reading ``start + t mod rows_i``; the draws are B at a time from a torch
  generator on the card seeded with ``(seed << 16) ^ epoch``.
- Decoding is Kaldi's CompressedMatrix: code c of a column with
  percentiles (p0, p25, p75, p100) is p0 + (p25 − p0)·(c / 64) for
  c <= 64, p25 + (p75 − p25)·((c − 64) / 128) for c <= 192, and
  p75 + (p100 − p75)·((c − 192) / 63) above.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def epoch_order(labels: np.ndarray, max_per_class: int, seed: int, epoch: int) -> np.ndarray:
    labels = np.asarray(labels, np.int64)
    _, inverse, counts = np.unique(labels, return_inverse=True, return_counts=True)
    cap = min(max_per_class, (int(counts.max()) + 1) // 2)
    reps = np.maximum(1, cap // counts[inverse])
    index = np.repeat(np.arange(len(labels)), reps)
    return index[np.random.default_rng((seed, epoch)).permutation(len(index))]


def decode(c: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """codes (B, T, F) uint8, percentiles (B, 4, F) → (B, T, F) f32."""
    c = c.to(torch.float32)
    p0, p25, p75, p100 = (pct[:, i:i + 1, :] for i in range(4))
    low = p0 + (p25 - p0) * (c * (1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - 64.0) * (1.0 / 128.0))
    high = p75 + (p100 - p75) * ((c - 192.0) * (1.0 / 63.0))
    return torch.where(c <= 64.0, low, torch.where(c <= 192.0, mid, high))


def crops(codes: torch.Tensor, pct: torch.Tensor, offsets: np.ndarray, rows: np.ndarray,
          labels: np.ndarray, max_per_class: int, seed: int, batch: int, frames: int,
          n_batches: int, epoch: int = 0) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The first ``n_batches`` (crops (B, F, T), labels (B,)) of ``epoch``."""
    dev = codes.device
    order = epoch_order(labels, max_per_class, seed, epoch)
    gen = torch.Generator(device=dev).manual_seed((seed << 16) ^ epoch)
    out = []
    t = np.arange(frames)
    for b in range(n_batches):
        ids = order[b * batch:(b + 1) * batch]
        u = torch.rand((batch,), generator=gen, device=dev).cpu().numpy()
        span = np.maximum(rows[ids] - frames + 1, 1).astype(np.float32)
        start = offsets[ids] + (u * span).astype(np.int32)
        idx = start[:, None] + t[None, :] % np.maximum(rows[ids], 1)[:, None]
        x = decode(codes[torch.as_tensor(idx, device=dev)], pct[torch.as_tensor(ids, device=dev)])
        out.append((x.transpose(1, 2).contiguous(),
                    torch.as_tensor(labels[ids], dtype=torch.int64, device=dev)))
    return out
