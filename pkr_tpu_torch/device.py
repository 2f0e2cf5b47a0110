"""Device selection, the strict-f32 switch and the host-to-device copy
shared by the port."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

from pkr_tpu_torch.utils import trace

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises:
    the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run f32 matmuls and convolutions in full f32 (TF32 off).

    The reference forces ``Precision.HIGHEST`` where the mantissa matters
    (the folded-DFT fbank for Kaldi parity, cosines near ±1); on the card
    cuBLAS keeps f32 matmuls in f32 by default but cuDNN runs f32
    convolutions in TF32, so both switches are set here and restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def as_device_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """numpy array or tensor → tensor on ``device`` (no copy when it is there).

    The port's host-to-device copies go through here.  While the tracer is
    on (``utils/trace.py``) a copy from the host to a card is counted
    (:func:`count_h2d`) and timed on the host as the span ``h2d``: a copy
    from pageable memory waits for the stream to drain, so the span holds
    the host's wait for the card as well as the staging of the bytes."""
    t = torch.as_tensor(x, dtype=dtype)
    if not trace.enabled() or not count_h2d(t, device):
        return t.to(device=device, dtype=dtype)
    with trace.span("h2d"):
        return t.to(device=device, dtype=dtype)


def count_h2d(t: torch.Tensor, device: DeviceLike) -> int:
    """The bytes ``t.to(device)`` sends from the host to a card (0 where it
    is no such copy), added to the counter ``h2d.bytes`` and, where ``t`` is
    not in pinned memory, to ``h2d.pageable_bytes``."""
    if t.device.type != "cpu" or torch.device(device).type != "cuda":
        return 0
    n = t.numel() * t.element_size()
    trace.count("h2d.bytes", n)
    if not t.is_pinned():
        trace.count("h2d.pageable_bytes", n)
    return n
