"""ResNet trunks for speaker embeddings (r-vector geometry).

Port of ``pkr_tpu/models/resnet.py``:
- stem: 3x3 stride-1 conv to 32 channels + BN + ReLU (no max-pool),
- stages 32/64/128/256 with strides 1/2/2/2 of BasicBlock (optionally with
  a squeeze-excitation gate, ``se_resnet34``) or Bottleneck
  (``resnet50/101/152``), both with expansion 1 as in the reference,
- 1x1-conv+BN downsample on a shape change,
- ``ThinResNet`` (``thin_resnet34``): a 7x7 stem to 8 channels, stages
  8/16/32/64 of BasicBlock, and the f32 mean over frequency, so it returns
  (B, C, T') where the others return the (B, C, F/8, T/8) map,
- Kaiming-normal(fan_out) conv init (drawn from ``generator`` when one is
  given), BN γ=1 β=0, eps 1e-5.

Shapes: the input (B, F, T) becomes (B, 1, H=F, W=T), and every map is
(B, C, F', T').  Every conv pads (k-1)//2 on each side, which is the
reference's "SAME" at stride 1 and its explicit symmetric padding at
stride 2.  Memory layout: a trunk's ``memory_format``, which
``models/layout.py`` sets from the device (channels_last on a CUDA device,
contiguous on the CPU), is the layout of its stem's input and so of every
map after it: convolutions, BatchNorm, ReLU, the residual adds, the
padding masks and the SE gate keep their input's layout.  While the tracer
is on (``utils/trace.py``) the counter ``trunk.channels_last`` counts the
calls whose stem emitted a channels_last map.

Module names follow the reference's state dict (``conv1``/``bn1`` stem,
``layerL.J.conv1/bn1/conv2/bn2[/conv3/bn3]/downsample.{0,1}``, the SE gate's
``layerL.J.se.fc.{0,2}``), so checkpoints move between the reference,
``pkr_tpu`` and the port by name.

Masks: with a (B, T) frame mask, padded time columns are re-zeroed after
the stem, inside each block before its time-mixing 3x3 conv and after each
block, which is what an exact-length run's conv zero padding sees — so
bucketed extraction equals exact-length extraction for every valid column.
The SE gate's squeeze averages over the valid columns only.

BatchNorm follows flax (``pkr_tpu`` uses ``flax.linen.BatchNorm``): in
train mode it normalizes with the biased batch variance and stages the
batch statistics; :func:`commit_batch_stats` folds them into the running
statistics with the biased variance, or drops them (the train step's NaN
guard).  Torch's ``BatchNorm2d`` would fold in the unbiased variance.
Over a process mesh a BatchNorm normalizes with the statistics of the
global batch, as ``pkr_tpu``'s does under pjit (:func:`set_batch_norm_group`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.distributed as dist
from torch import nn

from pkr_tpu_torch.utils import trace


def _conv(cin: int, cout: int, k: int, stride: int,
          generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2, bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu",
                            generator=generator)
    return conv


class _GroupSum(torch.autograd.Function):
    """x summed over a process group, differentiable: the gradient of each
    rank's input is the gradient of the sum summed over the group (every
    rank's loss depends on every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C) or (B, C, H, W), with flax's semantics.

    Eval mode normalizes with the running statistics.  Train mode normalizes
    with the batch mean and biased variance and leaves the running
    statistics alone: it stages the batch's (mean, biased variance) in
    ``staged`` for :func:`commit_batch_stats`.  The state-dict names are
    torch's (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so checkpoints move by name as before.

    ``group`` (None: this process's batch) is the data group of a process
    mesh: train mode then normalizes with the global batch's statistics,
    flax's under pjit.  The per-channel sums and the count are all-reduced
    with autograd, so every rank's gradient sees the whole batch.  The mean
    is E[x] and the variance the biased E[(x − E[x])²], in two passes (two
    all-reduces): flax forms E[x²] − E[x]², equal up to rounding, which in
    f32 loses the variance's digits where |E[x]| is many times the
    deviation (a ReLU block's output).  The count is global, so a batch of
    one is a global batch of one, and every rank stages the same
    statistics.  (Torch's ``SyncBatchNorm`` folds in the unbiased
    variance.)"""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum  # flax's momentum: ra = μ·ra + (1 − μ)·stat
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))
        self.staged = None
        self.group = None

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the data group's global batch."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dims = [0] + list(range(2, x.ndim))
        xf = x.to(torch.float32)
        c = x.shape[1]
        n = torch.full((1,), float(x.numel() // c), device=x.device)
        sums = _GroupSum.apply(torch.cat([xf.sum(dims), n]), self.group)
        count = sums[c].detach()
        mean = sums[:c] / count
        d = xf - mean.view(shape)
        var = _GroupSum.apply((d * d).sum(dims), self.group) / count
        y = d * torch.rsqrt(var + self.eps).view(shape) * self.weight.view(shape) \
            + self.bias.view(shape)
        self.staged = (mean.detach(), var.detach())
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.group is not None:
            return self._global_forward(x)
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


def set_batch_norm_group(model: nn.Module, group) -> None:
    """Set the data group (None: each process's own batch) of every
    :class:`BatchNorm` in ``model``: the trunk's, the DenseNets' and the
    head's ``bn1``."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group


def stem_input(x: torch.Tensor, memory_format: torch.memory_format) -> torch.Tensor:
    """A trunk's input (B, F, T) → the (B, 1, F, T) map in ``memory_format``,
    as a view: one channel holds the same bytes in either layout, and only
    the strides tell cuDNN which one it is.  A 4-D input is converted."""
    if x.ndim == 3:
        x = (x.unsqueeze(3).permute(0, 3, 1, 2) if memory_format == torch.channels_last
             else x[:, None])
    return x.contiguous(memory_format=memory_format)


def count_layout(x: torch.Tensor) -> None:
    """Count a trunk call under ``trunk.channels_last``: 1 where its stem
    emitted ``x`` channels_last, else 0 (nothing while the tracer is off)."""
    trace.count("trunk.channels_last", int(x.is_contiguous(memory_format=torch.channels_last)))


def zero_time_pad(x: torch.Tensor, n_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padded time columns of a (B, C, F, T) map (n_valid per
    batch row), in the map's layout."""
    if n_valid is None:
        return x
    keep = torch.arange(x.shape[3], device=x.device)[None, :] < n_valid[:, None]
    return x * keep[:, None, None, :].to(x.dtype)


def _dense(cin: int, cout: int, generator: Optional[torch.Generator] = None,
           bias: bool = True) -> nn.Linear:
    """Linear with the reference's flax Dense init (lecun normal, zero bias)."""
    lin = nn.Linear(cin, cout, bias=bias)
    nn.init.normal_(lin.weight, std=1.0 / math.sqrt(cin), generator=generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class SEGate(nn.Module):
    """Squeeze-excitation channel gate, reduction 16 (the reference's
    SELayer, ``fc = Linear, ReLU, Linear, Sigmoid``).

    The squeeze is the f32 mean over frequency and, with ``n_valid`` (B,),
    over the valid time columns only: padded columns of a bucketed batch
    must not leak into the gate.  The sigmoid runs in f32 and the gate is
    cast back to the map's dtype."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = nn.Sequential(_dense(channels, channels // reduction, generator, False),
                                nn.ReLU(),
                                _dense(channels // reduction, channels, generator, False),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if n_valid is None:
            y = torch.mean(xf, dim=(2, 3))
        else:
            m = (torch.arange(x.shape[3], device=x.device)[None, :]
                 < n_valid[:, None]).to(torch.float32)
            y = torch.sum(xf * m[:, None, None, :], dim=(2, 3))
            y = y / (x.shape[2] * torch.clamp(m.sum(dim=1), min=1.0))[:, None]
        g = self.fc[3](self.fc[:3](y).to(torch.float32)).to(x.dtype)
        return x * g[:, :, None, None]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, use_se: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, cout, 3, stride, generator)
        self.bn1 = BatchNorm(cout)
        self.conv2 = _conv(cout, cout, 3, 1, generator)
        self.bn2 = BatchNorm(cout)
        self.se = SEGate(cout, generator=generator) if use_se else None
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
        if self.se is not None:
            y = self.se(y, n_out)
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride) → 1x1 with expansion 1, as the reference.  The
    reference's bottleneck has no SE gate, so ``use_se`` is refused."""

    def __init__(self, cin: int, cout: int, stride: int = 1, use_se: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_se:
            raise ValueError("Bottleneck has no SE gate")
        self.stride = stride
        self.conv1 = _conv(cin, cout, 1, 1, generator)
        self.bn1 = BatchNorm(cout)
        self.conv2 = _conv(cout, cout, 3, stride, generator)
        self.bn2 = BatchNorm(cout)
        self.conv3 = _conv(cout, cout, 1, 1, generator)
        self.bn3 = BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride, generator),
                                            BatchNorm(cout))

    def forward(self, x: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = zero_time_pad(y, n_valid)  # the 3x3 below mixes across time
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Speaker-verification ResNet trunk; returns the (B, C, F/8, T/8) map."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BasicBlock,
                 base_width: int = 32, use_se: bool = False, stem_kernel: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.base_width = base_width
        self.memory_format = torch.contiguous_format  # models/layout.py sets it
        self.conv1 = _conv(1, base_width, stem_kernel, 1, generator)
        self.bn1 = BatchNorm(base_width)
        cin = base_width
        for i, n_blocks in enumerate(self.stage_sizes):
            cout = base_width * (2 ** i)
            blocks = []
            for j in range(n_blocks):
                blocks.append(block(cin, cout, 2 if (i > 0 and j == 0) else 1,
                                    use_se, generator))
                cin = cout
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.out_channels = cin

    @staticmethod
    def valid_out_frames(n):
        """Valid output frames for n valid input frames (three ceil-div-2
        stages: (k-1)//2 padding under stride 2)."""
        return (n + 7) // 8

    @staticmethod
    def out_freq(feat_dim: int) -> int:
        """Frequency rows of the output map for ``feat_dim`` input rows."""
        return (feat_dim + 7) // 8

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, F, T) [+ (B, T) mask] → (B, C, F/8, T/8)."""
        n_valid = None
        if mask is not None:
            n_valid = torch.sum(mask.to(torch.int64), dim=-1)
        x = self.conv1(stem_input(x, self.memory_format))
        count_layout(x)
        x = torch.relu(self.bn1(x))
        x = zero_time_pad(x, n_valid)
        for i in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, n_valid)
                if n_valid is not None and block.stride == 2:
                    n_valid = (n_valid + 1) // 2
                x = zero_time_pad(x, n_valid)
        return x


class ThinResNet(ResNet):
    """8/16/32/64-channel trunk with a 7x7 stem; returns (B, C, T').

    Known deviation, as ``pkr_tpu``'s (PARITY.md): the reference's
    AvgPool2d((1,3)) + view runs only when the trunk's time axis is exactly
    3 frames wide; the evident intent, a full frequency mean, runs at any
    length.  The mean is taken in f32 (under autocast a mean of a bf16 map
    would stay bf16)."""

    def __init__(self, stage_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(stage_sizes, BasicBlock, base_width=8, stem_kernel=7,
                         generator=generator)

    @staticmethod
    def out_freq(feat_dim: int) -> int:
        return 1

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, F, T) [+ (B, T) mask] → (B, C, T/8)."""
        return torch.mean(super().forward(x, mask).to(torch.float32), dim=2)


def tiny_resnet(**kw) -> ResNet:
    """1-block-per-stage, 8-channel trunk for tests and smoke runs."""
    return ResNet([1, 1, 1, 1], base_width=8, **kw)


def resnet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], **kw)


def resnet34(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], **kw)


def se_resnet34(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], use_se=True, **kw)


def thin_resnet34(**kw) -> ThinResNet:
    return ThinResNet([3, 4, 6, 3], **kw)


def resnet50(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet([3, 8, 36, 3], Bottleneck, **kw)
