"""Waveform input: wav.scp entries → float32 arrays in Kaldi's int16 scale.

A copy of ``pkr_tpu/io/wav.py`` for the port, which imports nothing of
``pkr_tpu``.

Handles the three wav.scp entry shapes the reference corpora use
(SURVEY §2.5):
- plain paths to PCM wav files,
- trailing-pipe commands (``ffmpeg ... -|`` for VoxCeleb2 m4a,
  make_voxceleb2.pl:54; sox pipes for VCTK/MUSAN),
- `segments`-style sub-ranges (extract-segments semantics: start/end seconds
  within a recording).

Values keep Kaldi's convention — raw int16 sample values as float32, NOT
normalized to ±1 — because every downstream constant (dither=1.0, VAD
threshold 5.5) assumes that scale.
"""

from __future__ import annotations

import io
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE blob → (float32 samples (n,) or (n, ch), rate)."""
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        arr = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 1:
        arr = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    elif width == 4:
        arr = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        arr = arr.reshape(-1, ch)
    return arr, rate


def read_wav(rxspec: str, channel: int = -1,
             start: Optional[float] = None, end: Optional[float] = None
             ) -> Tuple[np.ndarray, int]:
    """Load one wav.scp entry.  `rxspec` may end in '|' (command pipe).
    `start`/`end` in seconds implement the segments-file cut
    (extract-segments)."""
    if rxspec.rstrip().endswith("|"):
        cmd = rxspec.rstrip()[:-1].strip()
        data = subprocess.run(cmd, shell=True, check=True,
                              stdout=subprocess.PIPE).stdout
        wav, rate = read_wav_bytes(data)
    else:
        with open(rxspec.strip(), "rb") as f:
            wav, rate = read_wav_bytes(f.read())
    if wav.ndim == 2:
        wav = wav[:, max(channel, 0)]
    if start is not None or end is not None:
        s = int(round((start or 0.0) * rate))
        e = int(round(end * rate)) if end is not None else len(wav)
        wav = wav[s:e]
    return wav, rate


def write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Write mono int16-scale float samples as a PCM16 wav."""
    arr = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(arr.tobytes())
