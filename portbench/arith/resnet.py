"""FLOPs of the ResNet trunks, fc1 and the AAM head, from shapes.

Copied from ``pkr_tpu_torch/tools/train_roofline.py`` (``conv_geometry``,
``conv_layers``, ``linear_layers``, ``train_flops``) and widened to every
stage layout of the configurations: the stem, the blocks of two 3x3 convs,
the 1x1 downsample at each stage transition.  A train step counts 3x the
forward (the MFU convention: forward, dgrad, wgrad), convolutions and
matmuls only.
"""

from __future__ import annotations

from typing import List, NamedTuple

STAGES = {"resnet34": ((3, 4, 6, 3), 32), "resnet18": ((2, 2, 2, 2), 32),
          "tiny_resnet": ((1, 1, 1, 1), 8)}


class Conv(NamedTuple):
    name: str
    k: int
    stride: int
    c_in: int
    c_out: int
    h_out: int
    w_out: int

    @property
    def flops(self) -> float:
        """FLOPs of one pass for one example."""
        return 2.0 * self.k * self.k * self.c_in * self.c_out * self.h_out * self.w_out


def conv_geometry(trunk: str, feat_dim: int, frames: int) -> List[Conv]:
    """Every conv of the trunk for one (feat_dim x frames) input, in the
    order the forward runs them."""
    blocks_per_stage, width = STAGES[trunk]
    h, w = feat_dim, frames
    layers = [Conv("res.conv1", 3, 1, 1, width, h, w)]
    cin = width
    for li, nb in enumerate(blocks_per_stage, 1):
        c = width * 2 ** (li - 1)
        s = 1 if li == 1 else 2
        if s == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        for b in range(nb):
            first = b == 0
            pre = f"res.layer{li}.{b}"
            layers.append(Conv(f"{pre}.conv1", 3, s if first else 1, cin if first else c,
                               c, h, w))
            layers.append(Conv(f"{pre}.conv2", 3, 1, c, c, h, w))
            if first and (s != 1 or cin != c):
                layers.append(Conv(f"{pre}.downsample.0", 1, s, cin, c, h, w))
        cin = c
    return layers


def out_channels(trunk: str) -> int:
    blocks_per_stage, width = STAGES[trunk]
    return width * 2 ** (len(blocks_per_stage) - 1)


def fc1_in(trunk: str, feat_dim: int, n_stats: int = 2) -> int:
    return out_channels(trunk) * n_stats * ((feat_dim + 7) // 8)


def trunk_fwd_flops(trunk: str, feat_dim: int, frames: int, batch: int) -> float:
    return batch * sum(c.flops for c in conv_geometry(trunk, feat_dim, frames))


def linear_flops(trunk: str, feat_dim: int, emb_dim: int, n_spk: int, batch: int,
                 head: bool = True) -> float:
    """One forward pass of fc1 and, with ``head``, the AAM cosines."""
    f = 2.0 * fc1_in(trunk, feat_dim) * emb_dim
    if head:
        f += 2.0 * emb_dim * n_spk
    return batch * f


def train_flops(trunk: str, feat_dim: int, frames: int, emb_dim: int, n_spk: int,
                batch: int) -> float:
    """FLOPs of one train step: 3x the forward of the convolutions, fc1 and
    the head (``bench.py``'s ``resnet34_train_flops``: 3.48 TFLOP for
    ResNet-34 at B = 256 x 40 x 200 over 7325 speakers)."""
    return 3.0 * (trunk_fwd_flops(trunk, feat_dim, frames, batch)
                  + linear_flops(trunk, feat_dim, emb_dim, n_spk, batch))


def embed_flops(trunk: str, feat_dim: int, frames: int, emb_dim: int, batch: int) -> float:
    """FLOPs of one embedding forward: the trunk at ``frames`` and fc1."""
    return (trunk_fwd_flops(trunk, feat_dim, frames, batch)
            + linear_flops(trunk, feat_dim, emb_dim, 0, batch, head=False))

