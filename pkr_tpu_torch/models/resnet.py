"""ResNet trunks for speaker embeddings (r-vector geometry), NCHW.

Port of ``pkr_tpu/models/resnet.py``:
- stem: 3x3 stride-1 conv to 32 channels + BN + ReLU (no max-pool),
- stages 32/64/128/256 with strides 1/2/2/2, BasicBlock with expansion 1,
- 1x1-conv+BN downsample on a shape change,
- Kaiming-normal(fan_out) conv init (drawn from ``generator`` when one is
  given), BN γ=1 β=0, eps 1e-5.

Layout: the input (B, F, T) becomes (B, 1, H=F, W=T).  Every conv pads
(k-1)//2 on each side, which is the reference's "SAME" at stride 1 and its
explicit symmetric padding at stride 2.

Module names follow the reference's state dict (``conv1``/``bn1`` stem,
``layerL.J.conv1/bn1/conv2/bn2/downsample.{0,1}``), so checkpoints move
between the reference, ``pkr_tpu`` and the port by name.

Masks: with a (B, T) frame mask, padded time columns are re-zeroed after
the stem, inside each block after relu(conv1) and after each block, which is
what an exact-length run's conv zero padding sees — so bucketed extraction
equals exact-length extraction for every valid column.

BatchNorm follows flax (``pkr_tpu`` uses ``flax.linen.BatchNorm``): in
train mode it normalizes with the biased batch variance and stages the
batch statistics; :func:`commit_batch_stats` folds them into the running
statistics with the biased variance, or drops them (the train step's NaN
guard).  Torch's ``BatchNorm2d`` would fold in the unbiased variance.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _conv(cin: int, cout: int, k: int, stride: int,
          generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2, bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu",
                            generator=generator)
    return conv


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C) or (B, C, H, W), with flax's semantics.

    Eval mode normalizes with the running statistics.  Train mode normalizes
    with the batch mean and biased variance and leaves the running
    statistics alone: it stages the batch's (mean, biased variance) in
    ``staged`` for :func:`commit_batch_stats`.  The state-dict names are
    torch's (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so checkpoints move by name as before."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum  # flax's momentum: ra = μ·ra + (1 − μ)·stat
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))
        self.staged = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        if n == 1:
            # F.batch_norm refuses one value per channel in train mode; flax
            # takes it as its own mean with variance 0 and returns β
            shape = (1, -1) + (1,) * (x.ndim - 2)
            mean = x.reshape(-1).to(self.running_mean.dtype)
            var = torch.zeros_like(self.running_var)
            y = ((x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
                 * self.weight.view(shape) + self.bias.view(shape))
            self.staged = (mean.detach(), var)
            return y.to(x.dtype)
        # with momentum 1.0 the scratch buffers receive the batch's own mean
        # and unbiased variance from the very pass that normalizes
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        self.staged = (mean, var * ((n - 1) / n))
        return y


@torch.no_grad()
def commit_batch_stats(model: nn.Module, ok: torch.Tensor) -> None:
    """Fold every BatchNorm's staged batch statistics into its running ones,
    ``ra = μ·ra + (1 − μ)·stat`` as flax 0.12.3 does, where the bool tensor
    ``ok`` holds; then clear them.  Deciding with ``torch.where`` keeps the
    step free of a host sync."""
    for mod in model.modules():
        if not isinstance(mod, BatchNorm) or mod.staged is None:
            continue
        mu = mod.momentum
        for buf, stat in zip((mod.running_mean, mod.running_var), mod.staged):
            buf.copy_(torch.where(ok, mu * buf + (1.0 - mu) * stat, buf))
        mod.num_batches_tracked += ok.to(torch.int64)
        mod.staged = None


def zero_time_pad(x: torch.Tensor, n_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padded time columns of an NCHW map (n_valid per batch row)."""
    if n_valid is None:
        return x
    keep = torch.arange(x.shape[3], device=x.device)[None, :] < n_valid[:, None]
    return x * keep[:, None, None, :].to(x.dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, cout, 3, stride, generator)
        self.bn1 = BatchNorm(cout)
        self.conv2 = _conv(cout, cout, 3, 1, generator)
        self.bn2 = BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride, generator),
                                            BatchNorm(cout))

    def forward(self, x: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_out = None
        if n_valid is not None:  # valid frames at this block's output
            n_out = (n_valid + 1) // 2 if self.stride == 2 else n_valid
        y = torch.relu(self.bn1(self.conv1(x)))
        y = zero_time_pad(y, n_out)  # conv2 must not read BN-biased pads
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Speaker-verification ResNet trunk; returns the (B, C, F/8, T/8) map."""

    def __init__(self, stage_sizes: Sequence[int], base_width: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.base_width = base_width
        self.conv1 = _conv(1, base_width, 3, 1, generator)
        self.bn1 = BatchNorm(base_width)
        cin = base_width
        for i, n_blocks in enumerate(self.stage_sizes):
            cout = base_width * (2 ** i)
            blocks = []
            for j in range(n_blocks):
                blocks.append(BasicBlock(cin, cout, 2 if (i > 0 and j == 0) else 1,
                                         generator))
                cin = cout
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.out_channels = cin

    @staticmethod
    def valid_out_frames(n):
        """Valid output frames for n valid input frames (three ceil-div-2
        stages: (k-1)//2 padding under stride 2)."""
        return (n + 7) // 8

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, F, T) [+ (B, T) mask] → (B, C, F/8, T/8)."""
        if x.ndim == 3:
            x = x[:, None]
        n_valid = None
        if mask is not None:
            n_valid = torch.sum(mask.to(torch.int64), dim=-1)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = zero_time_pad(x, n_valid)
        for i in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, n_valid)
                if n_valid is not None and block.stride == 2:
                    n_valid = (n_valid + 1) // 2
                x = zero_time_pad(x, n_valid)
        return x


def tiny_resnet(**kw) -> ResNet:
    """1-block-per-stage, 8-channel trunk for tests and smoke runs."""
    return ResNet([1, 1, 1, 1], base_width=8, **kw)


def resnet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], **kw)


def resnet34(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], **kw)
