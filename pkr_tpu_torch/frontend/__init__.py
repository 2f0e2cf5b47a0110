"""Feature pipeline on the card: wav → fbank (or MFCC) → VAD → sliding CMVN."""

from pkr_tpu_torch.frontend.features import (
    FbankConfig,
    MfccConfig,
    frame_signal,
    fbank,
    mfcc,
    num_frames,
    mel_banks,
)
from pkr_tpu_torch.frontend.vad import VadConfig, energy_vad
from pkr_tpu_torch.frontend.cmvn import sliding_cmvn, select_voiced
from pkr_tpu_torch.frontend.pipeline import FrontendConfig, wav_to_train_feats

__all__ = [
    "FbankConfig",
    "MfccConfig",
    "VadConfig",
    "FrontendConfig",
    "frame_signal",
    "fbank",
    "mfcc",
    "num_frames",
    "mel_banks",
    "energy_vad",
    "sliding_cmvn",
    "select_voiced",
    "wav_to_train_feats",
]
