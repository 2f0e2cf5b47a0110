"""The speaker-embedding model: trunk → stats pooling → 256-d embedding → head.

Port of ``pkr_tpu/models/speaker_model.py`` (reference NeuralSpeakerModel):
- the trunk is selectable (``TRUNKS``: the ResNet family; ``DENSENETS``)
  and lives at ``res`` (the reference's name),
- fc1's input width is the trunk's channels × pooled statistics × its
  output frequency rows: ``(feat_dim + 7) // 8`` for the 4-D ResNet maps,
  1 for the (B, C, T') trunks (``thin_resnet34``, the DenseNets), whose
  sequence gets a unit frequency axis before pooling,
- heads: 'softmax' (bn1 + ReLU + Linear ``last``), 'AAM' (margin head on
  fc1, weight ``last.weight`` of shape (spk_num, emb_dim)), 'AAM-v1'
  (bn1 + ReLU, then the margin head),
- ``embed`` = trunk + pool + flatten + fc1, the reference's ``predict``.

The weights are drawn on the host, from ``generator`` (a CPU
``torch.Generator``) when one is given, so a seed gives the same weights on
every device.  The trunk takes its device's memory layout
(``models/layout.py``: channels_last on a CUDA device, contiguous on the
CPU) here and wherever a step or the extractor puts the model on a device.
``dtype`` is the trunk's compute type: bf16 runs the convolutions under
autocast (the speed path on the card), float32 runs them in full f32 with
TF32 off (the parity path).  Pooling and everything after it stay f32.

The module's mode is the reference's ``train`` flag: in train mode every
BatchNorm (trunk and ``bn1``) normalizes with batch statistics and stages
them for ``resnet.commit_batch_stats``; in eval mode it uses the running
statistics.  A new model is in eval mode; the train and eval steps set the
mode they need on every call.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pkr_tpu_torch.device import DeviceLike, full_f32, resolve_device
from pkr_tpu_torch.models import resnet as _resnet
from pkr_tpu_torch.models.densenet import DENSENETS
from pkr_tpu_torch.models.layout import use_device_layout
from pkr_tpu_torch.ops.aam import aam_logits
from pkr_tpu_torch.ops.stats_pool import flatten_pooled, stats_pool

TRUNKS = {
    "tiny_resnet": _resnet.tiny_resnet,
    "resnet18": _resnet.resnet18,
    "resnet34": _resnet.resnet34,
    "se_resnet34": _resnet.se_resnet34,
    "thin_resnet34": _resnet.thin_resnet34,
    "resnet50": _resnet.resnet50,
    "resnet101": _resnet.resnet101,
    "resnet152": _resnet.resnet152,
}


class AAMWeight(nn.Module):
    """The AAM classifier weight, (spk_num, emb_dim), as ``last.weight``."""

    def __init__(self, spk_num: int, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(spk_num, emb_dim))
        nn.init.xavier_normal_(self.weight, generator=generator)


class SpeakerModel(nn.Module):
    def __init__(self, spk_num: int, feat_dim: int = 40, pooling: str = "mean+std",
                 loss: str = "softmax", m: float = 0.2, s: float = 30.0,
                 trunk: str = "resnet34", emb_dim: int = 256,
                 dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        build = TRUNKS.get(trunk) or DENSENETS.get(trunk)
        if build is None:
            raise ValueError(f"unknown trunk {trunk!r} (choose from "
                             f"{sorted(TRUNKS) + sorted(DENSENETS)})")
        if loss not in ("softmax", "AAM", "AAM-v1"):
            raise ValueError(f"unknown loss {loss!r}")
        if pooling not in ("mean", "mean+std"):
            raise ValueError(f"unknown pooling {pooling!r}")
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
        self.spk_num, self.feat_dim, self.pooling = spk_num, feat_dim, pooling
        self.loss, self.m, self.s = loss, m, s
        self.trunk, self.emb_dim, self.dtype = trunk, emb_dim, dtype
        self.res = build(generator=generator)
        n_stats = 2 if pooling == "mean+std" else 1
        self.fc1 = _resnet._dense(
            self.res.out_channels * n_stats * self.res.out_freq(feat_dim), emb_dim, generator)
        if loss in ("softmax", "AAM-v1"):
            self.bn1 = _resnet.BatchNorm(emb_dim)
        if loss == "softmax":
            self.last = _resnet._dense(emb_dim, spk_num, generator)
        else:
            self.last = AAMWeight(spk_num, emb_dim, generator)
        use_device_layout(self.to(resolve_device(device)))
        self.eval()

    def _trunk(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        if self.dtype == torch.float32:
            with full_f32():
                return self.res(x.to(torch.float32), mask)
        with torch.autocast(device_type=x.device.type, dtype=self.dtype):
            return self.res(x, mask).to(torch.float32)

    def embed(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, F, T) [+ (B, T) frame mask] → (B, emb_dim) embeddings
        (reference ``predict``)."""
        fmap = self._trunk(x, mask)
        if fmap.ndim == 3:
            fmap = fmap[:, :, None, :]  # (B, C, T') trunks → (B, C, 1, T')
        tmask = None
        if mask is not None:
            n_valid = self.res.valid_out_frames(torch.sum(mask.to(torch.int64), dim=-1))
            tmask = (torch.arange(fmap.shape[3], device=fmap.device)[None, :]
                     < n_valid[:, None])
        pooled = stats_pool(fmap, tmask, self.pooling)
        with full_f32():
            return self.fc1(flatten_pooled(pooled))

    def head_input(self, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """What the classifier weight consumes: the raw embedding for 'AAM',
        relu(bn1(emb)) for 'AAM-v1'/'softmax'.  The flash head feeds it its
        cosine tiles."""
        emb = self.embed(x, mask)
        if self.loss == "AAM":
            return emb
        return torch.relu(self.bn1(emb))

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Classification logits (B, spk_num)."""
        h = self.head_input(x, mask)
        if self.loss == "softmax":
            with full_f32():
                return self.last(h)
        return aam_logits(h, self.last.weight, labels, self.m, self.s)
