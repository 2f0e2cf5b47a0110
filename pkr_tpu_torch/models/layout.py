"""The trunk's memory layout on each device.

On a CUDA device the trunk runs in ``torch.channels_last``: its maps keep
their (B, C, F, T) shape but hold the channels innermost in memory (NHWC),
and so do the convolutions' weights.  cuDNN's Hopper convolutions are NHWC
kernels, which on NCHW maps transpose each pass's input in and its output
back out, and PyTorch's channels-last BatchNorm kernels split each
channel's reduction over a 2-D grid, where its NCHW kernels give a channel
one thread block (the stem's 32 channels: 32 blocks on 132 SMs).  Elsewhere
the trunk stays contiguous (NCHW), so the CPU runs the arithmetic it always
ran.  The layout follows the device alone: there is no setting for it.
"""

from __future__ import annotations

import torch
from torch import nn

from pkr_tpu_torch.device import DeviceLike
from pkr_tpu_torch.models.densenet import DenseNet
from pkr_tpu_torch.models.resnet import ResNet


def memory_format_for(device: DeviceLike) -> torch.memory_format:
    """The trunk's layout on ``device``: channels_last on a CUDA device,
    contiguous elsewhere."""
    return (torch.channels_last if torch.device(device).type == "cuda"
            else torch.contiguous_format)


def use_device_layout(model: nn.Module) -> nn.Module:
    """Put ``model``'s trunks (their stem's input, so every map after it)
    and its 4-D parameters and buffers (the convolutions' weights) in the
    layout :func:`memory_format_for` gives the device its parameters live
    on.  Parameters keep their identity; a tensor already in the layout is
    left as it is.  Returns ``model``."""
    fmt = memory_format_for(next(model.parameters()).device)
    for mod in model.modules():
        if isinstance(mod, (ResNet, DenseNet)):
            mod.memory_format = fmt
    return model.to(memory_format=fmt)
