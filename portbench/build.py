"""What a run makes from its seed, on the card and in a few large calls:
the weights (by the reference's list of parameters) and the training
corpus of CompressedMatrix codes; and the program's model, given the
benchmark's weights by its state dict."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import resnet as ref_resnet

CROP_PAD = 1024  # zero rows after the last utterance, as the program's cache lays them out


def sub_seed(seed: int, stream: int) -> int:
    """An independent seed for each thing a run draws (weights, codes, ...)."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63)


def make_weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter and statistic of ``cfg``'s model, f32, the normal
    draws from one call on a generator seeded by ``seed``."""
    spec = ref_resnet.param_spec(cfg)
    total = sum(int(np.prod(shape)) for _, shape, kind, _ in spec if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, std in spec:
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out


@dataclass
class Corpus:
    codes: torch.Tensor      # (rows + CROP_PAD, F) uint8
    pct: torch.Tensor        # (n_utts, 4, F) f32
    offsets: np.ndarray      # (n_utts,) int64
    rows: np.ndarray         # (n_utts,) int64
    labels: np.ndarray       # (n_utts,) int64
    utts: List[str]


def make_corpus(spec: dict, feat_dim: int, seed: int, device: torch.device) -> Corpus:
    """``spec``: speakers, utts_per_speaker, frames [lo, hi].  Every seed
    gets the same set of utterance lengths (evenly spread over [lo, hi]),
    in its own order, so the work does not change with the seed; the codes
    are uniform bytes and each (utterance, bin)'s four percentiles sorted
    normal draws."""
    n_spk, per = int(spec["speakers"]), int(spec["utts_per_speaker"])
    lo, hi = spec["frames"]
    n = n_spk * per
    rng = np.random.default_rng(sub_seed(seed, 2))
    rows = rng.permutation(np.round(np.linspace(lo, hi, n)).astype(np.int64))
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    total = int(rows.sum())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    codes = torch.empty((total + CROP_PAD, feat_dim), dtype=torch.uint8, device=device)
    codes[:total].random_(0, 256, generator=gen)
    codes[total:].zero_()
    pct = torch.sort(2.0 * torch.randn((n, 4, feat_dim), generator=gen, device=device),
                     dim=1).values
    labels = np.repeat(np.arange(n_spk, dtype=np.int64), per)
    return Corpus(codes, pct, offsets, rows, labels, [str(i) for i in range(n)])


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device: torch.device):
    """The program's SpeakerModel for ``cfg``, built with ``device`` as the
    default device (so its own initial draws run there, not on the host)
    and given ``weights`` by its state dict."""
    from pkr_tpu_torch.models import SpeakerModel

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    with torch.device(device):
        model = SpeakerModel(cfg["n_spk"], cfg["feat_dim"], cfg["pooling"], cfg["loss"],
                             cfg["m"], cfg["s"], cfg["trunk"], cfg["emb_dim"], dtype,
                             device=device)
    model.load_state_dict(weights, strict=True)
    return model
