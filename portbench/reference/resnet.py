"""ResNet r-vector trunk, statistics pooling and fc1 as plain functions of a
dict of float32 tensors (the reference recipe's state-dict names).

- stem: 3x3 conv to ``width`` channels, BatchNorm, ReLU; stages of
  ``width·2^i`` channels, strides 1/2/2/2, of basic blocks (3x3 conv,
  BatchNorm, ReLU, 3x3 conv, BatchNorm, + the shortcut, ReLU; the shortcut
  a 1x1 conv + BatchNorm where the shape changes); every conv pads
  (k - 1) // 2 on each side;
- BatchNorm, eps 1e-5: in training the batch mean and biased variance over
  (N, H, W), the running statistics folded as r <- 0.9 r + 0.1 stat; in
  eval the running statistics;
- a (B, T) frame mask zeroes padded time columns after the stem, inside each
  block after its first ReLU and after each block, and keeps them out of
  the pooled statistics;
- pooling: the mean and the unbiased standard deviation (variance clamped at
  1e-10) over time, concatenated along frequency, flattened channel-major;
- fc1: a linear layer with bias.

The initial weights are drawn by the benchmark from :func:`param_spec`:
Kaiming normal (fan out) convolutions, BatchNorm γ = 1 and β = 0, fc1
normal with std 1/sqrt(fan in) and zero bias, the AAM weight Xavier normal.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = {"resnet34": ((3, 4, 6, 3), 32), "resnet18": ((2, 2, 2, 2), 32),
          "tiny_resnet": ((1, 1, 1, 1), 8)}
EPS = 1e-5
MOMENTUM = 0.9

Conv = Callable[[torch.Tensor, torch.Tensor, int, int], torch.Tensor]


def f32_conv(x, w, stride, padding):
    return F.conv2d(x, w, stride=stride, padding=padding)


def _blocks(trunk: str):
    """(name, c_in, c_out, stride, has_downsample) of every block."""
    per_stage, width = STAGES[trunk]
    out, cin = [], width
    for i, nb in enumerate(per_stage):
        c = width * 2 ** i
        for j in range(nb):
            s = 2 if (i > 0 and j == 0) else 1
            ci = cin if j == 0 else c
            out.append((f"res.layer{i + 1}.{j}", ci, c, s, s != 1 or ci != c))
        cin = c
    return out


def out_channels(trunk: str) -> int:
    per_stage, width = STAGES[trunk]
    return width * 2 ** (len(per_stage) - 1)


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every parameter and statistic: kind is
    'normal' (std), 'ones', 'zeros' or 'count' (an int64 zero)."""
    trunk, width = cfg["trunk"], STAGES[cfg["trunk"]][1]
    spec = []

    def conv(name, cin, cout, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), "normal",
                     math.sqrt(2.0 / (cout * k * k))))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "ones", 0.0), (f"{name}.bias", (c,), "zeros", 0.0),
                     (f"{name}.running_mean", (c,), "zeros", 0.0),
                     (f"{name}.running_var", (c,), "ones", 0.0),
                     (f"{name}.num_batches_tracked", (), "count", 0.0)])

    conv("res.conv1", 1, width, 3)
    bn("res.bn1", width)
    for name, cin, c, _, down in _blocks(trunk):
        conv(f"{name}.conv1", cin, c, 3)
        bn(f"{name}.bn1", c)
        conv(f"{name}.conv2", c, c, 3)
        bn(f"{name}.bn2", c)
        if down:
            conv(f"{name}.downsample.0", cin, c, 1)
            bn(f"{name}.downsample.1", c)
    n_stats = 2 if cfg["pooling"] == "mean+std" else 1
    d_in = out_channels(trunk) * n_stats * ((cfg["feat_dim"] + 7) // 8)
    spec.append(("fc1.weight", (cfg["emb_dim"], d_in), "normal", 1.0 / math.sqrt(d_in)))
    spec.append(("fc1.bias", (cfg["emb_dim"],), "zeros", 0.0))
    spec.append(("last.weight", (cfg["n_spk"], cfg["emb_dim"]), "normal",
                 math.sqrt(2.0 / (cfg["n_spk"] + cfg["emb_dim"]))))
    return spec


def is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var", "num_batches_tracked"))


def _zero_pad(x: torch.Tensor, n_valid: Optional[torch.Tensor]) -> torch.Tensor:
    if n_valid is None:
        return x
    keep = torch.arange(x.shape[3], device=x.device)[None, :] < n_valid[:, None]
    return x * keep[:, None, None, :].to(x.dtype)


def _bn(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, train: bool,
        stats: Optional[dict]) -> torch.Tensor:
    shape = (1, -1, 1, 1)
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean.view(shape)) ** 2).mean(dim=(0, 2, 3))
        stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS)
            * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape))


def trunk_forward(p: Dict[str, torch.Tensor], trunk: str, x: torch.Tensor, train: bool,
                  mask: Optional[torch.Tensor] = None, stats: Optional[dict] = None,
                  conv: Conv = f32_conv) -> torch.Tensor:
    """(B, F, T) features → (B, C, F/8, T/8); ``stats`` collects each
    BatchNorm's (batch mean, biased variance) in training."""
    n = None if mask is None else mask.to(torch.int64).sum(dim=-1)
    x = x[:, None]
    x = torch.relu(_bn(p, "res.bn1", conv(x, p["res.conv1.weight"], 1, 1), train, stats))
    x = _zero_pad(x, n)
    for name, _, _, s, down in _blocks(trunk):
        n_out = None if n is None else ((n + 1) // 2 if s == 2 else n)
        y = torch.relu(_bn(p, f"{name}.bn1", conv(x, p[f"{name}.conv1.weight"], s, 1),
                           train, stats))
        y = _zero_pad(y, n_out)
        y = _bn(p, f"{name}.bn2", conv(y, p[f"{name}.conv2.weight"], 1, 1), train, stats)
        if down:
            x = _bn(p, f"{name}.downsample.1", conv(x, p[f"{name}.downsample.0.weight"], s, 0),
                    train, stats)
        x = torch.relu(y + x)
        n = n_out
        x = _zero_pad(x, n)
    return x


def stats_pool(fmap: torch.Tensor, mask: Optional[torch.Tensor], pooling: str) -> torch.Tensor:
    """(B, C, F', T') [+ (B, T) input mask] → (B, C·2F') (or C·F')."""
    if mask is None:
        mean = fmap.mean(dim=3)
        var = ((fmap - mean[..., None]) ** 2).sum(dim=3) / max(fmap.shape[3] - 1, 1)
    else:
        n_in = mask.to(torch.int64).sum(dim=-1)
        n_valid = n_in
        for _ in range(3):
            n_valid = (n_valid + 1) // 2
        m = (torch.arange(fmap.shape[3], device=fmap.device)[None, :]
             < n_valid[:, None]).to(fmap.dtype)[:, None, None, :]
        cnt = torch.clamp(m.sum(dim=3), min=1.0)
        mean = (fmap * m).sum(dim=3) / cnt
        var = (((fmap - mean[..., None]) * m) ** 2).sum(dim=3) / torch.clamp(cnt - 1.0, min=1.0)
    pooled = mean if pooling == "mean" else torch.cat(
        [mean, torch.sqrt(torch.clamp(var, min=1e-10))], dim=2)
    return pooled.reshape(pooled.shape[0], -1)


def embed(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, train: bool,
          mask: Optional[torch.Tensor] = None, stats: Optional[dict] = None,
          conv: Conv = f32_conv) -> torch.Tensor:
    """(B, F, T) → (B, emb_dim): trunk, pooling, fc1."""
    fmap = trunk_forward(p, cfg["trunk"], x, train, mask, stats, conv)
    pooled = stats_pool(fmap, mask, cfg["pooling"])
    return pooled @ p["fc1.weight"].T + p["fc1.bias"]
