"""Card-resident quantized feature cache: sample training batches on the card.

Port of ``pkr_tpu/data/device_cache.py``.  The whole
training feature set is stored in device memory as uint8 codes with
per-(utterance, mel-bin) percentile tables — the same 3-piece quantization
as Kaldi's CompressedMatrix, 1 byte a value — and each training step
gathers and dequantizes its crops on the card: the host sends the sampler's
indices, and no feature value crosses the host link during training.

A crop is one gather, ``codes[start + t mod rows]`` for t < seq_len: the
identity window for an utterance of at least seq_len rows, and the host
loader's cyclic tiling for a shorter one.  The random starts come from (B,)
uniform draws handed in as a tensor, so a test can give both packages the
same numbers.  Round-trip error equals the CM codec's (tested).

Over a process mesh, ``ShardedDeviceFeatureCache`` splits the corpus
round-robin over the data axis, each rank holding only its shard on its
card, and ``ShardedCacheLoader`` draws each rank's share of a global batch
from its own shard: no feature crosses a card boundary either.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, as_device_tensor, resolve_device
from pkr_tpu_torch.utils import trace

# zero rows after the last utterance, as in the reference's buffer layout
# (there they keep its dynamic_slice from clamping; the gather here never
# reads past an utterance); bounds the supported seq_len
_CROP_PAD = 1024


def quantize_utterance(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, F) float32 → (codes uint8 (T, F), percentiles f32 (4, F)).

    Delegates to io.kaldi_ark.cm_quantize_columns — the SAME per-column
    quantizer as the on-disk CM codec, so the cache is bit-faithful to what
    `copy-feats --compress=true` training data looks like."""
    from pkr_tpu_torch.io.kaldi_ark import cm_quantize_columns

    mat = np.asarray(mat, np.float32)
    if mat.size:
        gmin = float(mat.min())
        grange = (float(mat.max()) - gmin) or 1.0
    else:
        gmin, grange = 0.0, 1.0
    _, pct, data = cm_quantize_columns(np.ascontiguousarray(mat.T), gmin, grange)
    return np.ascontiguousarray(data.T), np.ascontiguousarray(pct.T)


def dequantize(codes: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """codes (..., T, F) uint8 + pct (..., 4, F) → float32, branchless.

    The reference's formula as separate elementwise operations (no fused
    lerp or multiply-add), so each product and sum rounds on its own and the
    result equals a numpy evaluation of the same formula bit for bit."""
    c = codes.to(torch.float32)
    p0 = pct[..., 0:1, :]
    p25 = pct[..., 1:2, :]
    p75 = pct[..., 2:3, :]
    p100 = pct[..., 3:4, :]
    low = p0 + (p25 - p0) * (c * (1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - 64.0) * (1.0 / 128.0))
    high = p75 + (p100 - p75) * ((c - 192.0) * (1.0 / 63.0))
    return torch.where(c <= 64.0, low, torch.where(c <= 192.0, mid, high))


def _crop_index(offsets: torch.Tensor, rows: torch.Tensor, utt_ids: torch.Tensor,
                u: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, seq_len) rows of the code buffer that the crops read.  The start
    of utterance i is offsets[i] + trunc(u · max(rows[i] − seq_len + 1, 1)),
    formed in f32 as the reference forms it from its uniform draws u (B,);
    row t of the crop is start + t mod rows[i]."""
    r = rows[utt_ids]
    span = torch.clamp(r - seq_len + 1, min=1).to(torch.float32)
    starts = offsets[utt_ids] + (u * span).to(torch.int32)
    t = torch.arange(seq_len, dtype=torch.int32, device=offsets.device)
    return (starts[:, None] + t[None, :] % torch.clamp(r, min=1)[:, None]).to(torch.int64)


def _sample_cache(codes: torch.Tensor, pct: torch.Tensor, offsets: torch.Tensor,
                  rows: torch.Tensor, utt_ids: torch.Tensor, u: torch.Tensor,
                  seq_len: int) -> torch.Tensor:
    """Crops of the utterances ``utt_ids`` (B,) at the draws ``u`` (B,),
    decoded: (B, F, seq_len).  The cache buffers are arguments, as in the
    reference."""
    idx = _crop_index(offsets, rows, utt_ids, u, seq_len)
    feats = dequantize(codes[idx], pct[utt_ids])  # (B, T, F)
    # (B, F, T), like the host loader, and contiguous: a transposed view
    # would reach the convolutions in another memory format
    return feats.transpose(1, 2).contiguous()


class DeviceFeatureCache:
    """Quantized corpus in device memory with crop sampling on the card."""

    def __init__(self, codes: torch.Tensor, pct: torch.Tensor,
                 offsets: np.ndarray, rows: np.ndarray, utts: List[str],
                 labels: Optional[np.ndarray] = None):
        dev = codes.device
        self.codes = codes  # (total_rows + _CROP_PAD, F) uint8
        self.pct = pct      # (n_utts, 4, F) f32
        self.offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.int32).to(dev)
        self.rows = torch.as_tensor(np.asarray(rows), dtype=torch.int32).to(dev)
        self.utts = utts
        self.labels = (None if labels is None
                       else torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(dev))

    @staticmethod
    def build(mats: Dict[str, np.ndarray], labels: Optional[Dict[str, int]] = None,
              device: DeviceLike = None) -> "DeviceFeatureCache":
        dev = resolve_device(device)
        utts = list(mats)  # CALLER order — the sampler indexes the scp order
        F = next(iter(mats.values())).shape[1]
        offsets, rows, code_blocks, pcts = [], [], [], []
        off = 0
        for u in utts:
            c, p = quantize_utterance(mats[u])
            offsets.append(off)
            rows.append(c.shape[0])
            off += c.shape[0]
            code_blocks.append(c)
            pcts.append(p)
        code_blocks.append(np.zeros((_CROP_PAD, F), np.uint8))
        codes = torch.from_numpy(np.concatenate(code_blocks, axis=0)).to(dev)
        pct = torch.from_numpy(np.stack(pcts)).to(dev)
        lab = None
        if labels is not None:
            lab = np.asarray([labels[u] for u in utts], np.int64)
        return DeviceFeatureCache(codes, pct, np.asarray(offsets), np.asarray(rows), utts,
                                  lab)

    @staticmethod
    def from_scp(scp_path: str, utt2spkid: Optional[Dict[str, int]] = None,
                 device: DeviceLike = None) -> "DeviceFeatureCache":
        from pkr_tpu_torch.io import kaldi_ark

        mats = {u: m for u, m in kaldi_ark.read_mat_scp(scp_path)}
        return DeviceFeatureCache.build(mats, utt2spkid, device)

    @property
    def nbytes(self) -> int:
        return int(self.codes.numel() + self.pct.numel() * 4)

    def sample_batch(self, utt_ids, u: torch.Tensor, seq_len: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """seq_len crops of the given utterances at the (B,) uniform draws
        ``u`` in [0, 1) (the reference takes a PRNG key in their place),
        decoded on the card: (feats (B, F, seq_len) f32, labels (B,) or
        None).  Utterances shorter than seq_len start at their first row and
        are cyclically tiled to seq_len, exactly like the host loader's
        tiling."""
        if seq_len > _CROP_PAD:
            raise ValueError(f"seq_len {seq_len} > {_CROP_PAD}")
        dev = self.codes.device
        utt_ids = as_device_tensor(np.asarray(utt_ids), dev, torch.int64)
        feats = _sample_cache(self.codes, self.pct, self.offsets, self.rows, utt_ids,
                              u.to(device=dev, dtype=torch.float32), seq_len)
        labels = None if self.labels is None else self.labels[utt_ids]
        return feats, labels


class DeviceCacheLoader:
    """TrainLoader-compatible adapter: balanced sampler indices on the host,
    crop sampling and dequantization on the card.  Drop-in for
    train_and_validate: it yields tensors on the cache's device, which the
    train step takes as they are.  ``device`` (None: the card) must be the
    cache's."""

    def __init__(self, cache: DeviceFeatureCache, sampler, batch_size: int,
                 chunk: int = 200, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        if cache.codes.device.type != dev.type:
            raise ValueError(f"the cache is on {cache.codes.device}, not {dev}")
        if cache.labels is None:
            raise ValueError("the cache must be built with labels")
        self.cache = cache
        self.sampler = sampler
        self.batch_size = batch_size
        self.chunk = chunk
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def batches_per_epoch(self) -> int:
        return (len(self.sampler) // self.process_count) // self.batch_size

    def epoch(self, epoch: int):
        idx = self.sampler.epoch_indices(epoch, self.seed,
                                         self.process_index, self.process_count)
        dev = self.cache.codes.device
        gen = torch.Generator(device=dev).manual_seed((self.seed << 16) ^ epoch)
        n = len(idx) // self.batch_size
        for b in range(n):
            with trace.span("loader.batch"):
                sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                u = torch.rand((len(sel),), generator=gen, device=dev)
                batch = self.cache.sample_batch(sel, u, self.chunk)
            yield batch


class ShardedDeviceFeatureCache:
    """The quantized corpus split over a mesh's data axis, each rank holding
    its own shard on its card (``pkr_tpu``'s holds every shard in one
    process, one a device).

    Utterance i (in the caller's order) belongs to shard i mod n_data, at
    position i // n_data there: ``pkr_tpu``'s round-robin.  Every rank knows
    every shard's utterances, labels and count (host lists, for the
    samplers); only its own shard's codes and percentile tables are
    quantized and put on the card.  ``sample_batch`` takes ids into this
    rank's shard and the (B_local,) uniform draws of the crops' starts."""

    def __init__(self, shard: DeviceFeatureCache, data_index: int,
                 utts_per_shard: List[List[str]], labels_per_shard: List[np.ndarray]):
        self.shard = shard  # this rank's DeviceFeatureCache
        self.data_index = data_index
        self.utts_per_shard = utts_per_shard
        self.labels_per_shard = labels_per_shard
        self.n_utts = np.asarray([len(u) for u in utts_per_shard])  # per shard

    @staticmethod
    def build(mats: Dict[str, np.ndarray], labels: Dict[str, int], mesh,
              device: DeviceLike = None) -> "ShardedDeviceFeatureCache":
        n = int(mesh.n_data)
        utts = list(mats)  # CALLER order — the sampler indexes the scp order
        if len(utts) < n:
            raise ValueError(f"the sharded cache needs at least one utterance per data "
                             f"shard: got {len(utts)} for a {n}-way data axis")
        shards = [utts[d::n] for d in range(n)]
        mine = shards[mesh.data_index]
        shard = DeviceFeatureCache.build({u: mats[u] for u in mine},
                                         {u: labels[u] for u in mine}, device)
        return ShardedDeviceFeatureCache(
            shard, mesh.data_index, shards,
            [np.asarray([labels[u] for u in s], np.int64) for s in shards])

    @staticmethod
    def from_scp(scp_path: str, utt2spkid: Dict[str, int], mesh,
                 device: DeviceLike = None) -> "ShardedDeviceFeatureCache":
        """Reads only this rank's utterances of the scp."""
        from pkr_tpu_torch.io import kaldi_ark

        with open(scp_path) as f:
            entries = [line.strip().split(None, 1) for line in f if line.strip()]
        n = int(mesh.n_data)
        if len(entries) < n:
            raise ValueError(f"the sharded cache needs at least one utterance per data "
                             f"shard: got {len(entries)} for a {n}-way data axis")
        shards = [[u for u, _ in entries[d::n]] for d in range(n)]
        mats = {u: kaldi_ark.read_mat(rx) for u, rx in entries[mesh.data_index::n]}
        shard = DeviceFeatureCache.build(mats, utt2spkid, device)
        return ShardedDeviceFeatureCache(
            shard, mesh.data_index, shards,
            [np.asarray([utt2spkid[u] for u in s], np.int64) for s in shards])

    @property
    def nbytes_per_shard(self) -> int:
        return self.shard.nbytes

    def sample_batch(self, local_utt_ids, u: torch.Tensor, seq_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's share of a global batch: crops of its shard's
        utterances ``local_utt_ids`` (B_local,) at the draws ``u`` (B_local,),
        decoded on its card, and their labels."""
        return self.shard.sample_batch(local_utt_ids, u, seq_len)


class ShardedCacheLoader:
    """train_and_validate-compatible loader over a ShardedDeviceFeatureCache:
    this rank's B_local = batch_size / n_data rows of each global batch.

    Each shard runs its own BalancedRepetitionSampler over its utterances
    with seed ``seed + d`` (per-shard balance approximates the global
    balance, the utterances being dealt round-robin), and an epoch has as
    many batches as the shortest shard's sampler fills: ``pkr_tpu``'s
    shards, seeds and ids (:meth:`step_ids` gives the global ids of each
    step, segment d indexing into shard d).  The crops' uniform draws come
    from a generator on the card seeded by (seed, epoch, shard), in place of
    ``pkr_tpu``'s JAX key stream."""

    def __init__(self, cache: ShardedDeviceFeatureCache, batch_size: int,
                 chunk: int = 200, seed: int = 0, max_per_class: int = 500):
        from pkr_tpu_torch.data.sampler import BalancedRepetitionSampler

        n = len(cache.utts_per_shard)
        if batch_size % n:
            raise ValueError(f"batch {batch_size} does not split over {n} data shards")
        self.cache = cache
        self.batch_size = batch_size
        self.b_local = batch_size // n
        self.chunk = chunk
        self.seed = seed
        self.samplers = [BalancedRepetitionSampler(cache.utts_per_shard[d],
                                                   cache.labels_per_shard[d], max_per_class)
                         for d in range(n)]

    def batches_per_epoch(self) -> int:
        return min(len(s) for s in self.samplers) // self.b_local

    def step_ids(self, epoch: int):
        """The global ids of each step of the epoch, (batch_size,) int32:
        shard d's B_local ids at [d·B_local, (d + 1)·B_local)."""
        per_shard = [s.epoch_indices(epoch, self.seed + d)
                     for d, s in enumerate(self.samplers)]
        for b in range(self.batches_per_epoch()):
            yield np.concatenate([p[b * self.b_local:(b + 1) * self.b_local]
                                  for p in per_shard]).astype(np.int32)

    def epoch(self, epoch: int):
        d = self.cache.data_index
        dev = self.cache.shard.codes.device
        seed = (((self.seed * 0x9E3779B1 + epoch) & 0xFFFFFFFF) << 16) | d
        gen = torch.Generator(device=dev).manual_seed(seed)
        for ids in self.step_ids(epoch):
            with trace.span("loader.batch"):
                sel = ids[d * self.b_local:(d + 1) * self.b_local]
                u = torch.rand((len(sel),), generator=gen, device=dev)
                batch = self.cache.sample_batch(sel, u, self.chunk)
            yield batch
