"""wav → training features in one batched pass on the card.

Port of ``pkr_tpu/frontend/pipeline.py``: fbank, the energy VAD, sliding
CMVN and voiced-frame selection.  The recipe's MFCC pass only feeds
coefficient 0 (the raw log energy) to the VAD, so the signal is framed once
and the VAD energy comes from the same frames with its own dither draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from pkr_tpu_torch.device import DeviceLike, as_device_tensor, resolve_device
from pkr_tpu_torch.frontend.cmvn import select_voiced, sliding_cmvn
from pkr_tpu_torch.frontend.features import (
    FbankConfig,
    _dither,
    _fbank_frames,
    _log_energy,
    frame_signal,
)
from pkr_tpu_torch.frontend.vad import VadConfig, energy_vad
from pkr_tpu_torch.utils import trace


@dataclass(frozen=True)
class FrontendConfig:
    fbank: FbankConfig = field(default_factory=FbankConfig)
    vad: VadConfig = field(default_factory=VadConfig)
    cmn_window: int = 300
    cmn_center: bool = True
    cmn_norm_vars: bool = False


@trace.spanned("frontend")
def wav_to_train_feats(wav, length, generator: Optional[torch.Generator] = None,
                       cfg: FrontendConfig = FrontendConfig(),
                       max_frames: Optional[int] = None,
                       apply_vad: bool = True, device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N) int16-scale waveforms + (B,) lengths → CMVN'd voiced fbank.

    Returns (feats (B, T_max, n_mels), mask (B, T_max), vad (B, T_max)).
    With apply_vad=False the un-selected CMVN features and the VAD decisions
    are returned.  ``generator`` (a ``torch.Generator`` on ``device``) gives
    the two dither draws, fbank's first and the VAD energy's second; None
    means no dither.
    """
    dev = resolve_device(device)
    wav = as_device_tensor(wav, dev, torch.float32)
    length = as_device_tensor(length, dev, torch.int64)
    if wav.ndim == 1:
        wav, length = wav[None], length.reshape(1)
    fb_cfg = cfg.fbank
    frames, mask = frame_signal(wav, length, fb_cfg, max_frames)

    mel, _ = _fbank_frames(frames, fb_cfg, generator)

    # VAD energy: an independent dither draw on the same frames (the
    # reference's compute-mfcc-feats re-dithers; C0 = log raw energy of the
    # de-DC'd frame)
    x = _dither(frames.to(torch.float32), fb_cfg, generator)
    if fb_cfg.remove_dc_offset:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    loge = _log_energy(x, fb_cfg)

    vad = energy_vad(loge, mask, cfg.vad)
    feats = sliding_cmvn(mel, mask, cfg.cmn_window, cfg.cmn_center, cfg.cmn_norm_vars)
    if apply_vad:
        feats, mask = select_voiced(feats, vad, mask)
    return feats, mask, vad
