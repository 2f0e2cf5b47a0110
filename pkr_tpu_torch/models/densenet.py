"""DenseNet-BC trunks for speaker embeddings.

Port of ``pkr_tpu/models/densenet.py`` (the reference's
scripts/densenet.py: torchvision's DenseNet-BC with a 1-channel 7x7
stride-2 stem, no max-pool and a final BN, returning a (B, C, T') sequence
after the f32 mean over frequency):
- stem: 7x7 stride-2 conv (padding 3) + BN + ReLU,
- each dense layer: BN → ReLU → 1x1 conv to ``bn_size·growth`` → BN → ReLU
  → 3x3 conv to ``growth``, concatenated onto its input's channels,
- each transition: BN → ReLU → 1x1 conv to half the channels → 2x2
  stride-2 average pool (VALID, so T' = floor(T/2)),
- ``norm5``: a BN with no ReLU, then the mean over frequency.

Module names are torchvision's DenseNet names under ``features``, which the
reference's scripts/densenet.py inherits: ``features.conv0``, ``norm0``,
``denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}``,
``transition{i}.{norm,conv}`` and ``norm5``.  ``pkr_tpu``'s flax tree names
them ``stem``, ``BatchNorm_0``, ``block{i}_layer{j}/{BatchNorm,Conv}_{0,1}``,
``transition{i}/{BatchNorm,Conv}_0`` and ``final_norm``; ``convert`` and the
checkpoint warm start map one onto the other.

Maps are (B, C, F', T') in the trunk's ``memory_format`` (channels_last on
a CUDA device, contiguous on the CPU; ``models/layout.py``), as the
ResNets' are: the concatenations and the pools keep it.

Masks: with a (B, T) frame mask each dense layer zeroes the padded time
columns before its 3x3 conv, the only op that mixes across time, so a
bucketed batch embeds as its rows do at their exact lengths.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pkr_tpu_torch.models.resnet import (BatchNorm, _conv, count_layout, stem_input,
                                        zero_time_pad)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = bn_size * growth_rate
        self.norm1 = BatchNorm(cin)
        self.conv1 = _conv(cin, width, 1, 1, generator)
        self.norm2 = BatchNorm(width)
        self.conv2 = _conv(width, growth_rate, 3, 1, generator)

    def forward(self, x: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.conv1(torch.relu(self.norm1(x)))
        y = torch.relu(self.norm2(y))
        y = zero_time_pad(y, n_valid)  # the 3x3 must not read BN-biased pads
        y = self.conv2(y)
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = BatchNorm(cin)
        self.conv = _conv(cin, cout, 1, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """DenseNet-BC trunk; returns the (B, C, T') sequence."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block_config = tuple(block_config)
        self.memory_format = torch.contiguous_format  # models/layout.py sets it
        feats = nn.Module()
        feats.conv0 = _conv(1, num_init_features, 7, 2, generator)
        feats.norm0 = BatchNorm(num_init_features)
        n = num_init_features
        for i, n_layers in enumerate(self.block_config):
            block = nn.Module()
            for j in range(n_layers):
                block.add_module(f"denselayer{j + 1}",
                                 DenseLayer(n, growth_rate, bn_size, generator))
                n += growth_rate
            feats.add_module(f"denseblock{i + 1}", block)
            if i != len(self.block_config) - 1:
                feats.add_module(f"transition{i + 1}", Transition(n, n // 2, generator))
                n //= 2
        feats.norm5 = BatchNorm(n)
        self.features = feats
        self.out_channels = n

    @staticmethod
    def valid_out_frames(n: torch.Tensor) -> torch.Tensor:
        """Valid output frames for n valid input frames: the ceil-div-2
        stem, then three floor-div-2 VALID pools, at least 1."""
        return torch.clamp(((n + 1) // 2) // 8, min=1)

    @staticmethod
    def out_freq(feat_dim: int) -> int:
        return 1

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, F, T) [+ (B, T) mask] → (B, C, T')."""
        f = self.features
        x = f.conv0(stem_input(x, self.memory_format))
        count_layout(x)
        x = torch.relu(f.norm0(x))
        n_valid = None
        if mask is not None:  # the stem is ceil-div-2 on the time axis
            n_valid = (torch.sum(mask.to(torch.int64), dim=-1) + 1) // 2
        for i in range(len(self.block_config)):
            for layer in getattr(f, f"denseblock{i + 1}").children():
                x = layer(x, n_valid)
            if i != len(self.block_config) - 1:
                x = getattr(f, f"transition{i + 1}")(x)
                if n_valid is not None:  # VALID 2x2 pool: floor-div-2
                    n_valid = n_valid // 2
        x = f.norm5(x)
        return torch.mean(x.to(torch.float32), dim=2)


def densenet62(**kw) -> DenseNet:
    return DenseNet(growth_rate=8, block_config=(3, 6, 12, 8), num_init_features=15, **kw)


def densenet115(**kw) -> DenseNet:
    return DenseNet(growth_rate=16, block_config=(3, 12, 24, 16), num_init_features=8, **kw)


def densenet121(**kw) -> DenseNet:
    return DenseNet(growth_rate=16, block_config=(6, 12, 24, 16), num_init_features=8, **kw)


def densenet169(**kw) -> DenseNet:
    return DenseNet(growth_rate=16, block_config=(6, 12, 32, 32), num_init_features=8, **kw)


def densenet201(**kw) -> DenseNet:
    return DenseNet(growth_rate=32, block_config=(6, 12, 48, 32), num_init_features=64, **kw)


def densenet161(**kw) -> DenseNet:
    return DenseNet(growth_rate=48, block_config=(6, 12, 36, 24), num_init_features=96, **kw)


DENSENETS = {
    "densenet62": densenet62,
    "densenet115": densenet115,
    "densenet121": densenet121,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "densenet161": densenet161,
}
