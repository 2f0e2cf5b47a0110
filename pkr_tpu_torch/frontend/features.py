"""Kaldi-compatible log-mel filterbank as three f32 matmuls on the card, and
MFCC as one more (the DCT of the log-mels).

Port of ``pkr_tpu/frontend/features.py``.  The per-frame linear chain
diag(window) · Preemph · DeDC is folded with the real DFT basis into two
constant (window_size × num_fft_bins) matrices, so fbank is

    re = frames @ A_cos,  im = frames @ A_sin,  power = re² + im²,
    log(max(power @ melbank.T, eps))

with no FFT and no per-frame loop.  The constant matrices are built in
float64 numpy exactly as the reference builds them.

Precision: the reference forces ``Precision.HIGHEST`` on the three matmuls
for Kaldi parity; here they run under :func:`pkr_tpu_torch.device.full_f32`,
which keeps TF32 off.

Dither draws from an explicit ``torch.Generator``; it can never match the
reference's ``jax.random`` bits, so parity holds at dither=0 only.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, as_device_tensor, full_f32, resolve_device

EPS_F32 = float(np.finfo(np.float32).eps)
MEL_HIGH_FACTOR = 1127.0


@dataclass(frozen=True)
class FbankConfig:
    sample_frequency: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 40
    low_freq: float = 20.0
    high_freq: float = 7600.0  # conf/fbank.conf:4 (0.0 would mean Nyquist)
    dither: float = 1.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    raw_energy: bool = True
    energy_floor: float = 0.0
    snip_edges: bool = False  # conf/fbank.conf:6
    round_to_power_of_two: bool = True
    use_energy: bool = False
    use_log_fbank: bool = True
    use_power: bool = True
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    vtln_warp: float = 1.0
    blackman_coeff: float = 0.42

    @property
    def window_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms * 0.001)

    @property
    def window_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms * 0.001)

    @property
    def padded_window_size(self) -> int:
        w = self.window_size
        if not self.round_to_power_of_two:
            return w
        return 1 << (w - 1).bit_length()

    @property
    def num_fft_bins(self) -> int:
        return self.padded_window_size // 2 + 1


@dataclass(frozen=True)
class MfccConfig(FbankConfig):
    num_ceps: int = 40  # conf/mfcc.conf:6
    cepstral_lifter: float = 22.0
    use_energy: bool = True  # Kaldi compute-mfcc-feats default; C0 = log energy


def num_frames(num_samples, cfg: FbankConfig):
    """Frame count of an int or an integer tensor.
    snip_edges=false: (n + shift//2) // shift."""
    shift, win = cfg.window_shift, cfg.window_size
    if cfg.snip_edges:
        if isinstance(num_samples, int):
            return max(0, 1 + (num_samples - win) // shift)
        return torch.clamp(1 + (num_samples - win) // shift, min=0)
    return (num_samples + shift // 2) // shift


# ---------------------------------------------------------------------------
# constant matrices (host-side numpy, cached per config)
# ---------------------------------------------------------------------------


def _window_function(cfg: FbankConfig) -> np.ndarray:
    n = cfg.window_size
    a = 2 * math.pi / (n - 1)
    x = np.arange(n, dtype=np.float64)
    if cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * x)
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * x)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * x)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    elif cfg.window_type == "blackman":
        w = (cfg.blackman_coeff - 0.5 * np.cos(a * x)
             + (0.5 - cfg.blackman_coeff) * np.cos(2 * a * x))
    else:
        raise ValueError(f"unknown window {cfg.window_type}")
    return w


def _mel_scale(freq):
    return MEL_HIGH_FACTOR * np.log1p(np.asarray(freq, np.float64) / 700.0)


def _inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel, np.float64) / MEL_HIGH_FACTOR) - 1.0)


def _vtln_warp_freq(vtln_low: float, vtln_high: float, low: float, high: float,
                    warp: float, freq: np.ndarray) -> np.ndarray:
    """Kaldi's piecewise-linear VTLN warp."""
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    fl, fh = scale * l, scale * h
    scale_left = (fl - low) / (l - low)
    scale_right = (high - fh) / (high - h)
    res = np.where(freq >= h, high + scale_right * (freq - high), freq)
    res = np.where(freq < h, scale * freq, res)
    res = np.where(freq < l, low + scale_left * (freq - low), res)
    res = np.where((freq < low) | (freq > high), freq, res)
    return res


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, shape (num_mel_bins, num_fft_bins); the
    Nyquist bin column is zero (Kaldi MelBanks)."""
    nfft = cfg.padded_window_size
    nyquist = 0.5 * cfg.sample_frequency
    high = cfg.high_freq if cfg.high_freq > 0 else cfg.high_freq + nyquist
    vtln_high = cfg.vtln_high if cfg.vtln_high >= 0 else cfg.vtln_high + nyquist
    mel_low, mel_high = _mel_scale(cfg.low_freq), _mel_scale(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    b = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left, center, right = mel_low + b * delta, mel_low + (b + 1) * delta, mel_low + (b + 2) * delta
    if cfg.vtln_warp != 1.0:
        def warp(m):
            return _mel_scale(_vtln_warp_freq(cfg.vtln_low, vtln_high, cfg.low_freq,
                                              high, cfg.vtln_warp, _inverse_mel_scale(m)))
        left, center, right = warp(left), warp(center), warp(right)

    fft_bin_width = cfg.sample_frequency / nfft
    mel = _mel_scale(fft_bin_width * np.arange(nfft // 2, dtype=np.float64))[None, :]
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    if cfg.vtln_warp != 1.0:
        bins = np.zeros_like(up)
        up_idx = (mel > left) & (mel <= center)
        down_idx = (mel > center) & (mel < right)
        bins[up_idx] = up[up_idx]
        bins[down_idx] = down[down_idx]
    else:
        bins = np.maximum(0.0, np.minimum(up, down))
    out = np.zeros((cfg.num_mel_bins, cfg.num_fft_bins), dtype=np.float32)
    out[:, : nfft // 2] = bins
    return out


@functools.lru_cache(maxsize=16)
def _frontend_matrices(cfg: FbankConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A_cos, A_sin, melbank): the fused per-frame linear chain.

    A = DFT_basis^T · diag(window) · Preemph · DeDC, shape (win, nfft_bins),
    so that for a raw (dithered) frame x:  re = x @ A_cos, im = x @ A_sin
    equals rfft(zero_pad(window * preemph(de_dc(x)))).
    """
    win = cfg.window_size
    nfft = cfg.padded_window_size
    nbins = cfg.num_fft_bins

    chain = np.eye(win, dtype=np.float64)
    if cfg.remove_dc_offset:
        chain = chain - np.full((win, win), 1.0 / win)
    if cfg.preemphasis != 0.0:
        pre = np.eye(win) - cfg.preemphasis * np.eye(win, k=-1)
        pre[0, 0] = 1.0 - cfg.preemphasis  # x[0] -= p*x[0]
        chain = pre @ chain
    chain = np.diag(_window_function(cfg)) @ chain

    k = np.arange(nbins, dtype=np.float64)[:, None]  # (nbins, 1)
    n = np.arange(win, dtype=np.float64)[None, :]  # (1, win)
    ang = 2.0 * math.pi * k * n / nfft
    a_cos = (np.cos(ang) @ chain).T.astype(np.float32)  # (win, nbins)
    a_sin = (-np.sin(ang) @ chain).T.astype(np.float32)
    return a_cos, a_sin, mel_banks(cfg)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def frame_signal(wav: torch.Tensor, length: torch.Tensor, cfg: FbankConfig,
                 max_frames: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) padded waveforms + (B,) true lengths → frames (B, T, win) and
    frame mask (B, T).

    snip-edges=false mirrors the signal at both TRUE edges with edge
    duplication ([x2 x1 x0 | x0 x1 ... x_{n-1} | x_{n-1} x_{n-2} ...]).  The
    padded signal ("base", as in the reference) is built with index
    arithmetic and one gather, then framed as a strided view:

      q < pad                     → wav[pad-1-q]           (start mirror)
      pad ≤ q < pad+n             → wav[q-pad]
      pad+n ≤ q < pad+n+win       → wav[s0+win-1-(q-pad-n)], s0=max(n-win,0)
      pad+n+win ≤ q < pad+N       → wav[q-pad]             (caller's padding)
      otherwise                   → 0

    which is what the reference's concatenate + dynamic_update_slice
    produce.  Requires length >= window_size, as Kaldi does.
    """
    B, n_static = wav.shape
    shift, win = cfg.window_shift, cfg.window_size
    if max_frames is None:
        max_frames = int(num_frames(n_static, cfg))
    length = length.to(device=wav.device, dtype=torch.int64)
    mask = (torch.arange(max_frames, device=wav.device)[None, :]
            < num_frames(length, cfg)[:, None])

    n_rows = -(-win // shift)  # ceil
    need = (max_frames + n_rows) * shift
    q = torch.arange(need, device=wav.device)[None, :]  # (1, L)
    n = length[:, None]  # (B, 1)
    if cfg.snip_edges:
        src = q.expand(B, need)
        valid = src < n_static
    else:
        pad = win // 2 - shift // 2
        start = torch.clamp(n - win, min=0)
        in_patch = (q >= pad + n) & (q < pad + n + win)
        src = torch.where(in_patch, start + win - 1 - (q - pad - n),
                          torch.where(q < pad, pad - 1 - q, q - pad))
        valid = in_patch | (q < pad) | ((q - pad >= 0) & (q - pad < n_static))
    base = torch.gather(wav, 1, src.clamp(0, n_static - 1))
    base = torch.where(valid, base, torch.zeros((), dtype=wav.dtype, device=wav.device))
    frames = base.unfold(1, win, shift)[:, :max_frames]
    return frames, mask


# ---------------------------------------------------------------------------
# fbank
# ---------------------------------------------------------------------------


def _log_energy(frames_dc: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    e = torch.clamp(torch.sum(frames_dc * frames_dc, dim=-1), min=EPS_F32)
    loge = torch.log(e)
    if cfg.energy_floor > 0.0:
        loge = torch.clamp(loge, min=math.log(cfg.energy_floor))
    return loge


def _dither(x: torch.Tensor, cfg: FbankConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if cfg.dither == 0.0 or generator is None:
        return x
    noise = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=torch.float32)
    return x + cfg.dither * noise


def _fbank_frames(frames: torch.Tensor, cfg: FbankConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (..., win) → (log-mel (..., n_mels), log_energy (...))."""
    if not cfg.raw_energy:
        raise NotImplementedError("raw_energy=False not supported (unused by recipes)")
    a_cos, a_sin, banks = (as_device_tensor(m, frames.device)
                           for m in _frontend_matrices(cfg))
    x = _dither(frames.to(torch.float32), cfg, generator)
    # raw energy is measured after de-DC but before preemph/window
    xdc = x - torch.mean(x, dim=-1, keepdim=True) if cfg.remove_dc_offset else x
    loge = _log_energy(xdc, cfg)
    with full_f32():
        re = torch.matmul(x, a_cos)
        im = torch.matmul(x, a_sin)
        power = re * re + im * im
        if not cfg.use_power:
            power = torch.sqrt(power)
        mel = torch.matmul(power, banks.T)
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp(mel, min=EPS_F32))
    return mel, loge


def fbank(wav, length, cfg: FbankConfig = FbankConfig(),
          generator: Optional[torch.Generator] = None,
          max_frames: Optional[int] = None, device: DeviceLike = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched log-mel filterbank.

    Args:
      wav: (B, N) or (N,) float waveform in int16 scale (Kaldi convention:
        raw sample values — dither=1.0 assumes this scale).
      length: (B,) true sample counts.
      generator: ``torch.Generator`` on ``device`` for dither (None → none).
    Returns:
      feats (B, T_max, num_mel_bins [+1 energy]), mask (B, T_max) bool.
    """
    dev = resolve_device(device)
    wav = as_device_tensor(wav, dev, torch.float32)
    length = as_device_tensor(length, dev, torch.int64)
    if wav.ndim == 1:
        wav, length = wav[None], length.reshape(1)
    frames, mask = frame_signal(wav, length, cfg, max_frames)
    mel, loge = _fbank_frames(frames, cfg, generator)
    if cfg.use_energy:
        mel = torch.cat([loge[..., None], mel], dim=-1)
    return mel, mask


def _dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II with Kaldi's C0 convention, shape (num_bins, num_ceps)."""
    n = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_bins, dtype=np.float64)[:, None]
    m = np.sqrt(2.0 / num_bins) * np.cos(math.pi / num_bins * (n + 0.5) * k)  # (k, n)
    m = m.T  # right-multiply form: (num_bins, num_bins)
    m[:, 0] = math.sqrt(1.0 / num_bins)
    return m[:, :num_ceps].astype(np.float32)


def _lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def mfcc(wav, length, cfg: MfccConfig = MfccConfig(),
         generator: Optional[torch.Generator] = None,
         max_frames: Optional[int] = None, device: DeviceLike = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MFCC: the DCT of the log-mels (a full-f32 matmul, like
    fbank's), liftered; with use_energy, C0 is the raw log energy, which is
    what the energy VAD consumes (kaldi.py:602-650).

    Returns feats (B, T_max, num_ceps), mask (B, T_max) bool."""
    dev = resolve_device(device)
    wav = as_device_tensor(wav, dev, torch.float32)
    length = as_device_tensor(length, dev, torch.int64)
    if wav.ndim == 1:
        wav, length = wav[None], length.reshape(1)
    frames, mask = frame_signal(wav, length, cfg, max_frames)
    base = replace(cfg, use_energy=False, use_log_fbank=True, use_power=True)
    mel, loge = _fbank_frames(frames, base, generator)
    with full_f32():
        feats = torch.matmul(mel, as_device_tensor(
            _dct_matrix(cfg.num_ceps, cfg.num_mel_bins), dev))
    if cfg.cepstral_lifter != 0.0:
        feats = feats * as_device_tensor(_lifter_coeffs(cfg.num_ceps, cfg.cepstral_lifter), dev)
    if cfg.use_energy:
        feats = torch.cat([loge[..., None], feats[..., 1:]], dim=-1)
    return feats, mask
