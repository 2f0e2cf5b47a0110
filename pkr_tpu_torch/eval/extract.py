"""Embedding extraction.

Port of ``make_embed_fn`` and ``extract_embeddings`` from
``pkr_tpu/eval/extract.py``: masked, length-bucketed batches go through
``SpeakerModel.embed`` on one card, and every utterance is embedded once.
``pkr_tpu``'s ``mesh=`` path splits each batch over a host's devices; here
a card is a process, so several cards split the utterances instead: each
rank embeds the shard its ``EvalLoader(process_index, process_count)``
yields, on its own card, and writes its own ark (``recipes/run.py``'s
``run_extract``).  A batch comes as float features or, from an
``EvalLoader`` over CompressedMatrix arks, as its uint8 codes and
percentile tables, dequantized on the card (a quarter of the f32 bytes
cross the host link).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from pkr_tpu_torch.data.device_cache import dequantize
from pkr_tpu_torch.device import DeviceLike, as_device_tensor, resolve_device
from pkr_tpu_torch.models.layout import use_device_layout
from pkr_tpu_torch.utils import trace

SEG_SEP = "##"


def make_embed_fn(model, device: DeviceLike = None
                  ) -> Callable[..., torch.Tensor]:
    """Returns embed(feats (B, F, T), mask (B, T), pct=None) → (B, emb_dim)
    on the device.  The model is moved to ``device`` and takes its trunk
    layout (``models/layout.py``); every call puts it in eval mode, so a
    train step run in between does not leave BatchNorm on batch statistics.

    Feature batches cross to the card in the trunk's compute type: for a
    bf16 model the first conv casts its input to bf16 anyway, so the cast
    before the copy changes nothing and halves the bytes.  With ``pct``
    (B, 4, F), ``feats`` are CM codes (B, T, F) uint8: they cross as bytes,
    are dequantized on the card, and the padded frames are re-zeroed (code 0
    decodes to the column's p0, not 0.0), so the stem sees the float path's
    zero padding."""
    dev = resolve_device(device)
    use_device_layout(model.to(dev))
    xfer = model.dtype

    @trace.spanned("extract.embed")
    @torch.no_grad()
    def embed(feats, mask, pct=None):
        model.eval()
        mask = as_device_tensor(mask, dev, torch.bool)
        if pct is None:
            feats = as_device_tensor(feats, dev, xfer)
        else:
            codes = as_device_tensor(feats, dev, torch.uint8)
            x = dequantize(codes, as_device_tensor(pct, dev, torch.float32))
            feats = (x * mask[:, :, None]).transpose(1, 2).contiguous()  # (B, F, T)
        return model.embed(feats, mask)

    return embed


def extract_embeddings(model, loader: Iterable[Tuple[List[str], object, object]],
                       device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Embed every batch of ``loader`` — any iterable of (keys, feats
    (B, F, T) or (codes (B, T, F) uint8, pct (B, 4, F)), mask (B, T)) — and
    return {utt: embedding}.

    Segment keys ('<utt>##<k>') are mean-pooled back into one embedding per
    utterance.  Up to four batches stay in flight before their embeddings
    are copied back, so host work overlaps the card."""
    embed = make_embed_fn(model, device)
    out: Dict[str, np.ndarray] = {}
    seg_sum: Dict[str, np.ndarray] = {}
    seg_cnt: Dict[str, int] = {}
    sep = getattr(loader, "SEG_SEP", SEG_SEP)

    def absorb(keys, arr):
        for k, e in zip(keys, arr):
            if sep in k:
                utt = k.rsplit(sep, 1)[0]
                seg_sum[utt] = seg_sum.get(utt, 0.0) + e
                seg_cnt[utt] = seg_cnt.get(utt, 0) + 1
            else:
                out[k] = e

    pending: List[Tuple[List[str], torch.Tensor]] = []
    for keys, feats, mask in loader:
        if isinstance(feats, tuple):  # quantized transport (codes, pct)
            emb = embed(feats[0], mask, pct=feats[1])
        else:
            emb = embed(feats, mask)
        pending.append((list(keys), emb))
        if len(pending) >= 4:
            k, e = pending.pop(0)
            absorb(k, e.cpu().numpy())
    for k, e in pending:
        absorb(k, e.cpu().numpy())
    for utt, total in seg_sum.items():
        out[utt] = (total / seg_cnt[utt]).astype(np.float32)
    return out
