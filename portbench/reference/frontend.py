"""Kaldi's feature pipeline for the recipe (conf/fbank.conf, conf/vad.conf,
``apply-cmvn-sliding --center=true --cmn-window=300``,
``select-voiced-frames``), written from Kaldi's definitions in float64:

- frames of 400 samples every 160 (snip-edges false: frame t starts at
  160·t + 80 − 200, the signal reflected at both ends, sample −1 reading
  sample 0);
- fbank: dither (Gaussian, scale 1, the first of two draws), the mean
  removed, pre-emphasis 0.97 (the first sample against itself), Povey
  window, zero padding to 512, the power spectrum, 40 triangular mel bins
  from 20 to 7600 Hz on Kaldi's mel scale (1127 ln(1 + f / 700)), the log
  floored at float32's epsilon;
- VAD: each frame's log energy (a second dither draw, the mean removed,
  floored at epsilon), the threshold 5.5 + 0.5 x the utterance's mean log
  energy, a frame voiced where at least 12 % of the frames within ±2 of it
  exceed the threshold;
- CMVN: each frame less the mean of the 300-frame window centred on it,
  the window shifted (not shrunk) to lie inside the utterance;
- the voiced frames compacted to the front, the rest zero and masked.

``tf32`` rounds the operands of the two spectral products (the windowed
frames and the power spectrum, with the mel matrix) to TF32's 10-bit
mantissa: the control for a float32 frontend.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

RATE, WIN, SHIFT, NFFT, MELS = 16000, 400, 160, 512, 40
LOW, HIGH = 20.0, 7600.0
EPS = float(np.finfo(np.float32).eps)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


def mel_matrix() -> np.ndarray:
    """(MELS, NFFT // 2) triangular weights over the bins below Nyquist."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    lo, hi = mel(LOW), mel(HIGH)
    delta = (hi - lo) / (MELS + 1)
    b = np.arange(MELS, dtype=np.float64)[:, None]
    left, centre, right = lo + b * delta, lo + (b + 1) * delta, lo + (b + 2) * delta
    m = mel(np.arange(NFFT // 2, dtype=np.float64) * RATE / NFFT)[None, :]
    return np.maximum(0.0, np.minimum((m - left) / (centre - left), (right - m) / (right - centre)))


def frames(wav: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N) → (B, T, WIN) float64 frames of the first n samples."""
    T = (n + SHIFT // 2) // SHIFT
    idx = (torch.arange(T, device=wav.device)[:, None] * SHIFT + SHIFT // 2 - WIN // 2
           + torch.arange(WIN, device=wav.device)[None, :])
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    return wav[:, :n].to(torch.float64)[:, idx]


def features(wav: torch.Tensor, n: int, generator: torch.Generator, dither: float = 1.0,
             tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) wavs of n samples → (voiced CMVN fbank (B, T, MELS) f32,
    mask (B, T))."""
    fr = frames(wav, n)
    B, T, _ = fr.shape
    d1 = torch.randn((B, T, WIN), generator=generator, device=wav.device, dtype=torch.float32)
    d2 = torch.randn((B, T, WIN), generator=generator, device=wav.device, dtype=torch.float32)
    x = fr + dither * d1.to(torch.float64)
    x = x - x.mean(dim=-1, keepdim=True)
    x = torch.cat([x[..., :1] * (1 - 0.97), x[..., 1:] - 0.97 * x[..., :-1]], dim=-1)
    k = torch.arange(WIN, dtype=torch.float64, device=wav.device)
    x = x * (0.5 - 0.5 * torch.cos(2 * math.pi * k / (WIN - 1))) ** 0.85
    if tf32:
        x = tf32_round(x.to(torch.float32)).to(torch.float64)
    power = torch.fft.rfft(x, n=NFFT, dim=-1).abs() ** 2
    banks = torch.as_tensor(mel_matrix(), device=wav.device)
    if tf32:
        power = tf32_round(power.to(torch.float32)).to(torch.float64)
        banks = tf32_round(banks.to(torch.float32)).to(torch.float64)
    fbank = torch.log(torch.clamp(power[..., :NFFT // 2] @ banks.T, min=EPS))

    e = fr + dither * d2.to(torch.float64)
    e = e - e.mean(dim=-1, keepdim=True)
    loge = torch.log(torch.clamp((e * e).sum(dim=-1), min=EPS))
    above = (loge > 5.5 + 0.5 * loge.mean(dim=1, keepdim=True)).to(torch.float64)
    num = torch.zeros_like(above)
    den = torch.zeros_like(above)
    for off in range(-2, 3):
        lo, hi = max(0, -off), min(T, T - off)
        num[:, lo:hi] += above[:, lo + off:hi + off]
        den[:, lo:hi] += 1.0
    voiced = num >= den * 0.12

    t = torch.arange(T, device=wav.device)
    w = min(300, T)
    start = torch.clamp(t - 150, min=0)
    start = torch.clamp(torch.minimum(start, torch.full_like(start, T - w)), min=0)
    csum = torch.cat([torch.zeros((B, 1, MELS), dtype=fbank.dtype, device=wav.device),
                      torch.cumsum(fbank, dim=1)], dim=1)
    mean = (csum[:, start + w] - csum[:, start]) / w
    cmvn = fbank - mean

    out = torch.zeros((B, T, MELS), dtype=torch.float32, device=wav.device)
    mask = torch.zeros((B, T), dtype=torch.bool, device=wav.device)
    for b in range(B):
        kept = cmvn[b][voiced[b]]
        out[b, :kept.shape[0]] = kept.to(torch.float32)
        mask[b, :kept.shape[0]] = True
    return out, mask
