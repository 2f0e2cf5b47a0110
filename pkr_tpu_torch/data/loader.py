"""Host-side feature loading, chunking, batching and device prefetch.

A copy of ``pkr_tpu/data/loader.py`` for the port, which imports nothing
of ``pkr_tpu``.  Batches stay numpy; the port's train and embed steps move
them to the card.


Replaces the reference DataLoader path (datasets.py + DataLoader workers +
DistributedSampler, train_resnet.py:234-247): scp random access via
pkr_tpu_torch.io, seeded random crops, fixed-shape batches, and a one-deep
background prefetch thread that overlaps ark reads with device compute.

Layout note: batches are (B, F, T) float32 — feature rows transposed once at
read time, the same orientation the reference datasets emit
(datasets.py:68) — so the model's (B, 1, F, T) view is free.

`EvalLoader` fixes the reference's fragile variable-length extraction
(SURVEY §2.2 EmbeddingDataset caveat): utterances are grouped into
length buckets (multiples of `bucket_quantum` frames), padded to the bucket
length, and emitted with masks, so the card sees one shape per bucket
instead of one per utterance length.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pkr_tpu_torch.io import kaldi_ark


class FeatureSource:
    """Random-access feature reader over a feats.scp (rxspecifier per utt).

    Uses the native C++ reader (pkr_tpu_torch.io.native, crop-aware CM decode) for
    plain ``path:offset`` entries when libpkr_ark.so is available; pipes,
    gzip and exotic formats fall back to the python codec.
    """

    def __init__(self, scp_path: str, use_native: bool = True):
        from pkr_tpu_torch.io import native

        self.utts: List[str] = []
        self.rx: List[str] = []
        for ln, line in enumerate(open(scp_path), 1):
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(
                    f"{scp_path}:{ln}: malformed scp line {line.strip()!r}")
            self.utts.append(parts[0])
            self.rx.append(parts[1])
        self._cache: Optional[Dict[int, np.ndarray]] = None
        self._native = native if (use_native and native.available()) else None
        self._split = [native.split_rxspec(r) for r in self.rx] if self._native else None
        self._dims: Dict[int, Tuple[int, int]] = {}

    def __len__(self):
        return len(self.utts)

    def cache_in_memory(self) -> None:
        """Materialize all matrices (tiny corpora / benchmarks)."""
        self._cache = {i: self.read(i) for i in range(len(self.rx))}

    def _demote(self, i: int) -> None:
        """Entry i turned out not to be native-decodable (ascii payload,
        format the fast path doesn't cover): route it to the python codec
        permanently instead of raising on every touch."""
        self._split[i] = None

    def read(self, i: int) -> np.ndarray:
        if self._cache is not None:
            return self._cache[i]
        if self._native is not None and self._split[i] is not None:
            path, off = self._split[i]
            try:
                return self._native.read_mat(path, off)
            except IOError:
                self._demote(i)
        return kaldi_ark.read_mat(self.rx[i])

    def dims(self, i: int) -> Tuple[int, int]:
        if i not in self._dims:
            if self._cache is not None:
                self._dims[i] = self._cache[i].shape
            elif self._native is not None and self._split[i] is not None:
                path, off = self._split[i]
                try:
                    self._dims[i] = self._native.mat_dims(path, off)
                except IOError:
                    self._demote(i)
                    self._dims[i] = kaldi_ark.read_mat_dims(self.rx[i])
            else:  # header-only: no full decode just for a shape
                self._dims[i] = kaldi_ark.read_mat_dims(self.rx[i])
        return self._dims[i]

    def read_codes(self, i: int):
        """Raw CM format-1 payload for quantized device transport:
        (codes (T, F) uint8, pct (4, F) f32), or None when the entry is a
        different format (then the caller reads float32 via read()).  The
        result is value-lossless: dequantizing the codes reproduces read(i)
        bit-for-bit (io.kaldi_ark.read_mat_codes)."""
        if self._cache is not None:
            return None
        try:
            return kaldi_ark.read_mat_codes(self.rx[i])
        except (IOError, ValueError):
            return None

    def read_crop_t(self, i: int, row_start: int, n_rows: int,
                    out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """(F, n_rows) crop via the native decoder; None if unavailable."""
        if self._cache is not None or self._native is None or self._split[i] is None:
            return None
        path, off = self._split[i]
        _, cols = self.dims(i)
        try:
            return self._native.read_crop_t(path, off, row_start, n_rows,
                                            cols, out)
        except IOError:
            self._demote(i)
            return None


def _random_crop_at(mat: np.ndarray, seq_len: int, pin: int) -> np.ndarray:
    """Contiguous seq_len-frame crop at `pin` (datasets.py:66-67), tiled
    cyclically for utterances shorter than seq_len (those are excluded
    upstream by the ≥200-frame filter; tiling beats crashing the step)."""
    n = len(mat)
    if pin + seq_len <= n:
        return mat[pin:pin + seq_len]
    idx = (pin + np.arange(seq_len)) % n
    return mat[idx]


class TrainLoader:
    """Iterator of (feats (B, F, T), labels (B)) numpy batches for one epoch.

    Drops the trailing partial batch (static shapes).  chunk: int for a fixed
    crop, or (min, max) for a per-epoch random crop size
    (--min/max-chunk-size, datasets.py:41-43).
    """

    def __init__(self, source: FeatureSource, labels: Sequence[int], sampler,
                 batch_size: int, chunk=200, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2):
        self.source = source
        self.labels = np.asarray(labels, np.int64)
        self.sampler = sampler
        self.batch_size = batch_size
        self.chunk = chunk
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch

    def _chunk_for_epoch(self, epoch: int) -> int:
        if isinstance(self.chunk, int):
            return self.chunk
        lo, hi = min(self.chunk), max(self.chunk)
        if lo == hi:
            return lo
        rng = np.random.default_rng((self.seed, epoch, 2))
        return int(rng.integers(lo, hi + 1))

    def batches_per_epoch(self) -> int:
        per_host = len(self.sampler) // self.process_count
        return per_host // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self.sampler.epoch_indices(epoch, self.seed,
                                         self.process_index, self.process_count)
        seq_len = self._chunk_for_epoch(epoch)
        n_batches = len(idx) // self.batch_size
        rng = np.random.default_rng((self.seed, epoch, 3, self.process_index))

        def load_one(i: int, out: np.ndarray) -> None:
            rows, _ = self.source.dims(i)
            # utterances shorter than the crop tile cyclically; randomize
            # the phase within the cycle (pin in [0, rows)) — a fixed pin=0
            # would repeat the identical crop every epoch
            hi = rows - seq_len + 1 if rows >= seq_len else rows
            pin = int(rng.integers(0, max(hi, 1)))
            got = self.source.read_crop_t(i, pin, seq_len, out)
            if got is None:  # python fallback (pipes/gzip/no native lib)
                out[:] = _random_crop_at(self.source.read(i), seq_len, pin).T

        stop = threading.Event()

        def produce(q: "queue.Queue"):
            def put(item) -> bool:
                # bounded put that aborts when the consumer is gone — a
                # plain q.put would block forever if the epoch generator is
                # abandoned mid-epoch (exception in the train step), leaking
                # one producer thread (+ its open ark fds) per aborted epoch
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    feat_dim = self.source.dims(int(sel[0]))[1]
                    feats = np.empty((len(sel), feat_dim, seq_len), np.float32)
                    for j, i in enumerate(sel):
                        load_one(int(i), feats[j])
                    if not put((feats, self.labels[sel])):
                        return
                put(None)
            except BaseException as exc:  # propagate to the training loop
                put(exc)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer stuck in put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


def bucket_lengths(lengths: Sequence[int], quantum: int = 100,
                   max_len: Optional[int] = None) -> np.ndarray:
    """Round each length up to a multiple of `quantum` (and cap)."""
    out = ((np.asarray(lengths) + quantum - 1) // quantum) * quantum
    if max_len is not None:
        out = np.minimum(out, max_len)
    return out


class EvalLoader:
    """Length-bucketed, padded, masked batches for embedding extraction.

    Yields (utt_keys, payload, mask (B, Tb)) with all items in a batch
    sharing bucket length Tb.  payload is EITHER feats (B, F, Tb) float32
    OR — for CompressedMatrix format-1 entries under the default
    transport='auto' — a (codes (B, Tb, F) uint8, pct (B, 4, F) float32)
    tuple for on-device dequantization (eval.extract handles both; pass
    transport='f32' for the plain ndarray contract).  Every utterance
    appears exactly once — no DistributedSampler padding, no dedup pass.

    long_mode handles utterances beyond max_len (the reference simply ran
    arbitrary lengths through dynamic shapes — datasets.py:185-189):
    'truncate' keeps the first max_len frames; 'average' splits the
    utterance into max_len windows emitted as segment keys
    '<utt>##<k>' which extract_embeddings mean-pools back into one
    embedding per utterance (the standard long-audio recipe; keeps every
    compiled shape bounded).
    """

    SEG_SEP = "##"

    def __init__(self, source: FeatureSource, batch_size: int = 8,
                 quantum: int = 100, max_len: Optional[int] = 2000,
                 chunk_size: int = -1, long_mode: str = "truncate",
                 seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 pad_to_batch: bool = True, transport: str = "auto"):
        # transport: 'auto' ships CompressedMatrix format-1 entries as raw
        # uint8 codes + percentile tables and dequantizes ON DEVICE (4× less
        # host→device traffic than f32, 2× less than the bf16 cast; values
        # bit-identical — io.kaldi_ark.read_mat_codes); 'f32' forces the
        # float path.  Non-CM entries always go f32; mixed corpora emit the
        # two payload kinds in separate buckets.
        if transport not in ("auto", "f32"):  # raise survives python -O
            raise ValueError(f"transport must be 'auto' or 'f32': {transport!r}")
        self.transport = transport
        # pipe-probe memo for 'auto': a codes miss on a PIPE rxspecifier ran
        # the whole pipe for nothing and read() must rerun it, so one pipe
        # miss disables further probes.  Plain path:offset misses are two
        # cheap preads — keep probing those per entry, because the repo's
        # own encoder mixes formats (kAutomaticMethod emits CM2 for <=8-row
        # matrices amid CM1 neighbours) and a corpus-wide latch would
        # silently drop quantized transport for the whole pass.
        self._pipe_codes_dead = False
        self.source = source
        self.batch_size = batch_size
        self.quantum = quantum
        self.max_len = max_len
        self.chunk_size = chunk_size
        self.long_mode = long_mode
        self.rng = np.random.default_rng(seed)
        self.my_ids = list(range(process_index, len(source), process_count))
        # pad final partial buckets to the full batch size so a corpus pass
        # sees at most max_len/quantum shapes (a ragged tail per bucket
        # would otherwise add one each); consumers drop the pad rows because
        # `keys` keeps its true length.
        self.pad_to_batch = pad_to_batch

    def _read_payload(self, i: int):
        """(mat_rows, pct_or_None): rows are (T, F) float32 OR (T, F) uint8
        codes with a (4, F) pct table.  Row slicing (crops, truncation,
        segmenting) is format-agnostic, so everything downstream of this
        read treats the two identically."""
        reader = getattr(self.source, "read_codes", None)
        if self.transport == "auto" and reader is not None:
            rx = getattr(self.source, "rx", None)
            is_pipe = bool(rx) and rx[i].rstrip().endswith("|")
            if not (is_pipe and self._pipe_codes_dead):
                cp = reader(i)
                if cp is not None:
                    return cp
                if is_pipe:
                    self._pipe_codes_dead = True
        return self.source.read(i), None

    def _segments(self, i: int):
        mat, pct = self._read_payload(i)
        if self.chunk_size > 0:
            # random contiguous crop, like the reference EmbeddingDataset
            # with chunk_size > 0 (datasets.py:185-187)
            if len(mat) > self.chunk_size:
                pin = int(self.rng.integers(0, len(mat) - self.chunk_size + 1))
                mat = mat[pin:pin + self.chunk_size]
        utt = self.source.utts[i]
        if (self.max_len is None or len(mat) <= self.max_len
                or self.long_mode == "truncate"):
            yield utt, (mat[: self.max_len] if self.max_len else mat), pct
            return
        n_seg = -(-len(mat) // self.max_len)
        for k in range(n_seg):
            seg = mat[k * self.max_len:(k + 1) * self.max_len]
            yield f"{utt}{self.SEG_SEP}{k}", seg, pct

    def __iter__(self) -> Iterator[Tuple[List[str], object, np.ndarray]]:
        # read lazily: one pass grouping by (bucket length, payload kind)
        buckets: Dict[Tuple[int, bool], List[tuple]] = {}
        for i in self.my_ids:
            for key, mat, pct in self._segments(i):
                L = int(bucket_lengths([len(mat)], self.quantum, self.max_len)[0])
                bk = (L, pct is not None)
                buckets.setdefault(bk, []).append((key, mat[: L], pct))
                if len(buckets[bk]) == self.batch_size:
                    yield self._emit(L, buckets.pop(bk))
        for bk in sorted(buckets):
            yield self._emit(bk[0], buckets[bk])

    def _emit(self, L: int, items):
        B = len(items)
        rows = self.batch_size if (self.pad_to_batch
                                   and B < self.batch_size) else B
        F = items[0][1].shape[1]
        quantized = items[0][2] is not None
        mask = np.zeros((rows, L), bool)
        mask[B:] = True  # pad rows: full mask over zero features, so the
        keys = []        # masked pooling never divides by a zero count
        if quantized:
            # (B, T, F) codes + (B, 4, F) tables; zero pct rows dequantize
            # to exact zeros, matching the f32 zero padding
            codes = np.zeros((rows, L, F), np.uint8)
            pcts = np.zeros((rows, 4, F), np.float32)
            for b, (key, cod, pct) in enumerate(items):
                codes[b, : len(cod)] = cod
                pcts[b] = pct
                mask[b, : len(cod)] = True
                keys.append(key)
            return keys, (codes, pcts), mask
        feats = np.zeros((rows, F, L), np.float32)
        for b, (key, mat, _) in enumerate(items):
            feats[b, :, : len(mat)] = mat.T
            mask[b, : len(mat)] = True
            keys.append(key)
        return keys, feats, mask
