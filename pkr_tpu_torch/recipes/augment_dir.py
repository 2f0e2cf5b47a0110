"""Corpus-level augmentation: build augmented/speed-perturbed data dirs, and
the MUSAN/RIR pools that feed the augmenter on the card.

Port of ``pkr_tpu/recipes/augment_dir.py``.  The reference doubles its corpus by rewriting wav.scp entries into
wav-reverberate pipe commands (steps/data/{augment,reverberate}_data_dir.py,
invoked at run.sh:93-148) and supports sox speed perturbation
(utils/perturb_data_dir_speed.sh).  Here the data dir carries *declarative*
augmentation tables instead of shell pipes:

- ``utt2aug``:  '<kind>' per utterance (noise|music|babble|reverb), applied
  on the card by run_features via pkr_tpu_torch.data.augment just before the
  fused frontend;
- ``utt2speed``: playback factor per utterance, applied on host right after
  wav decode.

Augmented copies get the reference's utt suffixes ('-noise', '-music',
'-babble', '-reverb'; speed copies get Kaldi's 'sp<factor>-' prefix) so
downstream tables stay sorted and the speaker labels follow automatically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pkr_tpu_torch.device import DeviceLike, resolve_device
from pkr_tpu_torch.io.datadir import DataDir

AUG_KINDS = ("noise", "music", "babble", "reverb")


def augment_data_dir(dd: DataDir, kinds: Sequence[str] = AUG_KINDS,
                     seed: int = 0) -> DataDir:
    """clean + one augmented copy per utterance with a random kind
    (augment_data_dir.py composition; run.sh:162-164 doubles the corpus)."""
    from pkr_tpu_torch.io.datadir import _UTT_TABLES

    rng = np.random.default_rng(seed)
    utt2spk = dict(dd["utt2spk"])
    wav = dict(dd["wav.scp"])
    utt2aug = {u: "none" for u in utt2spk}
    # carry utt-keyed CONFIGURATION tables to the augmented copies
    # (utt2warp/VTLN, utt2speed, text) — but NOT tables describing already-
    # computed audio/features (feats.scp/vad.scp/utt2num_frames/utt2dur):
    # those are wrong for the derived signal and would make stage 1 feed
    # clean features for the "augmented" half
    drop = ("utt2spk", "wav.scp", "utt2aug",
            "feats.scp", "vad.scp", "utt2num_frames", "utt2dur")
    extra = {n: dict(dd[n]) for n in _UTT_TABLES
             if n in dd and n not in drop}
    for utt in sorted(dd["utt2spk"]):
        kind = kinds[rng.integers(0, len(kinds))]
        new = f"{utt}-{kind}"
        utt2spk[new] = dd["utt2spk"][utt]
        wav[new] = dd["wav.scp"][utt]
        utt2aug[new] = kind
        for n, t in extra.items():
            if utt in dd[n]:
                t[new] = dd[n][utt]
    tables = {"utt2spk": utt2spk, "wav.scp": wav, "utt2aug": utt2aug}
    tables.update(extra)
    return DataDir(tables).make_spk2utt()


def perturb_data_dir_speed(dd: DataDir, factors: Sequence[float] = (0.9, 1.1),
                           keep_original: bool = True) -> DataDir:
    """Speed-perturbed copies 'sp<f>-<utt>' (perturb_data_dir_speed.sh)."""
    from pkr_tpu_torch.io.datadir import _UTT_TABLES

    utt2spk, wav, utt2speed = {}, {}, {}
    drop = ("utt2spk", "wav.scp", "utt2speed",
            "feats.scp", "vad.scp", "utt2num_frames", "utt2dur")
    extra = {n: {} for n in _UTT_TABLES if n in dd and n not in drop}
    if keep_original:
        utt2spk.update(dd["utt2spk"])
        wav.update(dd["wav.scp"])
        utt2speed.update({u: "1.0" for u in dd["utt2spk"]})
        for n in extra:
            extra[n].update(dd[n])
    for f in factors:
        for utt, spk in dd["utt2spk"].items():
            new = f"sp{f}-{utt}"
            utt2spk[new] = f"sp{f}-{spk}"  # Kaldi convention: new speaker ids
            wav[new] = dd["wav.scp"][utt]
            utt2speed[new] = str(f)
            for n in extra:
                if utt in dd[n]:
                    extra[n][new] = dd[n][utt]
    tables = {"utt2spk": utt2spk, "wav.scp": wav, "utt2speed": utt2speed}
    tables.update(extra)
    return DataDir(tables).make_spk2utt()


class AugmentPools:
    """MUSAN/RIR waveform pools, padded to fixed lengths for mixing on
    `device` (None: the card)."""

    def __init__(self, noise=None, music=None, speech=None, rirs=None,
                 seed: int = 0, snr: Optional[dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.snr = snr
        self.pools: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if noise is not None:
            self.pools["noise"] = noise
        if music is not None:
            self.pools["music"] = music
        if speech is not None:
            self.pools["babble"] = speech
        self.rirs = rirs
        self.rvb_noise = None
        self.reverb_planner = None
        self.rng = np.random.default_rng(seed)
        self._augmenter = None
        self._proxy = None
        self._shards: Dict[str, dict] = {}   # full-corpus rotation state
        self._prefetch = None
        self._rows = 0
        self._rotate_rows = 0
        self._rate = 16000
        self._max_len = 0
        # rotation observability (stage1_metrics.jsonl)
        self.rotations_done = 0
        self.rotation_wait_batches = 0
        self.rotation_errors = 0

    def attach_rir_set(self, rir_dir: str,
                       noise_set_params=None,
                       foreground_snrs=(20.0,), background_snrs=(20.0,),
                       speech_rvb_probability: float = 1.0,
                       pointsource_noise_addition_probability: float = 1.0,
                       isotropic_noise_addition_probability: float = 1.0,
                       max_noises_per_minute: float = 1.0,
                       max_rirs: int = 4096, max_rir_sec: float = 1.0,
                       max_noise_sec: float = 6.0,
                       rate: int = 16000) -> "AugmentPools":
        """Wire a RIRS_NOISES-style corpus into the reverb branch
        (reverberate_data_dir.py's role; driven from run.sh:93-130 with
        smallroom+mediumroom at probability 0.5 each and NO additive
        noises — pass noise_set_params for the full fg/bg composition).

        Loads the (probability-subsampled) RIR wavs plus a trailing delta
        (unit-impulse) row the planner uses for 'no reverb drawn' rows, and
        an optional rvb-noise pool for iso/point-source additions.
        """
        from pkr_tpu_torch.recipes.rir import (ReverbPlanner, find_rir_sets,
                                               load_pool_wavs, parse_noise_list,
                                               parse_rir_list)

        rirs = parse_rir_list(find_rir_sets(rir_dir), base_dir=rir_dir)
        point, iso = ([], {})
        if noise_set_params:
            point, iso = parse_noise_list(noise_set_params, base_dir=rir_dir)
        planner = ReverbPlanner(
            rirs, point, iso,
            foreground_snrs=foreground_snrs, background_snrs=background_snrs,
            speech_rvb_probability=speech_rvb_probability,
            pointsource_noise_addition_probability=(
                pointsource_noise_addition_probability),
            isotropic_noise_addition_probability=(
                isotropic_noise_addition_probability),
            max_noises_per_minute=max_noises_per_minute,
            max_rirs=max_rirs, seed=int(self.rng.integers(2 ** 31)),
            rate=rate)
        mats, lens = load_pool_wavs([r.path for r in planner.rirs],
                                    max_rir_sec, rate)
        # trailing delta RIR: convolution identity (peak at 0, power 1) for
        # rows whose draw skips the reverb but keeps additive noises
        delta = np.zeros((1, mats.shape[1]), np.float32)
        delta[0, 0] = 1.0
        self.rirs = (np.concatenate([mats, delta]),
                     np.concatenate([lens, np.asarray([1], lens.dtype)]))
        if planner.noise_entries:
            self.rvb_noise = load_pool_wavs(
                [e.path for e in planner.noise_entries], max_noise_sec, rate)
        self.reverb_planner = planner
        self._augmenter = None  # rebuild with the new pools
        self._proxy = None
        return self

    @staticmethod
    def from_wavs(wavs: List[np.ndarray], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        mats = np.zeros((len(wavs), max_len), np.float32)
        lens = np.zeros(len(wavs), np.int64)
        for i, w in enumerate(wavs):
            n = min(len(w), max_len)
            mats[i, :n] = w[:n]
            lens[i] = n
        return mats, lens

    @staticmethod
    def load(datadirs: Dict[str, DataDir], max_len_sec: float = 12.0, rate: int = 16000,
             seed: int = 0,
             snr: Optional[dict] = None, shard_mb: int = 256,
             rotate_rows: int = 2000, device: DeviceLike = None) -> "AugmentPools":
        """Read pool audio from MUSAN-style data dirs (make_musan output).

        Scales to the FULL corpus: each kind's recordings are split into
        fixed-shape (K, L) shards packed to ~shard_mb of device memory each;
        the live shard rotates every `rotate_rows` augmented utterances (the
        next shard decoded into numpy on a host thread, so rotation never
        stalls the device pipeline; it is uploaded on the main thread),
        cycling a shuffled order over the whole corpus.  Fixed shard shapes
        keep the tile budget's accounting exact across rotations.

        The per-recording cap is max_len_sec (default 12 s ≈ the long tail
        of VoxCeleb utterance durations).  This is faithful to the
        reference, not a shortcut: augment_data_dir.py mixes every
        background noise FROM ITS START (`wav-reverberate --duration=dur
        noise`, start_times 0 — :83-92), so only the head of each MUSAN
        recording up to the utterance duration is ever read there either."""
        rng = np.random.default_rng(seed)
        max_len = int(max_len_sec * rate)
        bytes_per = max_len * 4
        shard_k = max(2, (shard_mb << 20) // bytes_per)
        out = AugmentPools(seed=seed, snr=snr, device=device)
        out._rate = rate
        out._max_len = max_len
        out._rotate_rows = rotate_rows
        for kind_src, kind_dst in (("noise", "noise"), ("music", "music"),
                                   ("speech", "babble")):
            dd = datadirs.get(kind_src)
            if dd is None:
                continue
            entries = list(dd["wav.scp"].values())
            rng.shuffle(entries)
            k = min(shard_k, len(entries))
            out._shards[kind_dst] = {"files": entries, "pos": 0, "k": k}
            out.pools[kind_dst] = out._read_shard(kind_dst)
        return out

    def _read_shard(self, kind: str) -> Tuple[np.ndarray, np.ndarray]:
        """Next K recordings of the kind's shuffled cycle, decoded on a
        thread pool (wav entries may be subprocess pipes), head-truncated
        to the pool length."""
        from multiprocessing.pool import ThreadPool

        from pkr_tpu_torch.io.wav import read_wav

        st = self._shards[kind]
        files, k = st["files"], st["k"]
        sel = [files[(st["pos"] + i) % len(files)] for i in range(k)]
        st["pos"] = (st["pos"] + k) % len(files)
        with ThreadPool(min(4, k)) as tp:
            wavs = tp.map(lambda rx: read_wav(rx)[0][:self._max_len], sel)
        return AugmentPools.from_wavs(wavs, self._max_len)

    def _rotating_kinds(self) -> List[str]:
        return [k for k, st in self._shards.items()
                if st["k"] < len(st["files"])]

    def _maybe_rotate(self) -> None:
        """Swap in prefetched shards once rotate_rows utterances have been
        augmented; kick off the next prefetch.  Skips (keeps the current
        shard) when the prefetch thread hasn't finished — augmentation
        never blocks on pool IO."""
        kinds = self._rotating_kinds()
        if (not kinds or self._rotate_rows <= 0
                or self._rows < self._rotate_rows):
            return
        if self._prefetch is None:  # first crossing: start the prefetch
            self._start_prefetch(kinds)
            return
        if self._prefetch["thread"].is_alive():
            # the diversity contract is observable: rotation_wait_batches
            # counts augmenter calls that ran while a due rotation waited
            # on a slow prefetch (surfaced in the training JSONL) — a
            # large value means the host trained against one shard far
            # longer than rotate_rows promises
            self.rotation_wait_batches += 1
            return
        if self._prefetch["pools"]:
            # count only cycles that actually swapped a shard in: a cycle
            # where every prefetch failed must not inflate the diversity
            # metric (the failures get their own counter)
            self.rotations_done += 1
        self.rotation_errors += len(self._prefetch["errors"])
        for kind, err in self._prefetch["errors"].items():
            # a failed shard read must be VISIBLE, not silently skipped:
            # the kind keeps its current pool this cycle and rotation
            # retries it next time
            print(f"WARNING: augment pool shard prefetch failed for "
                  f"'{kind}': {err!r} — keeping the current shard")
        for kind, pool in self._prefetch["pools"].items():
            self.pools[kind] = pool
            if self._augmenter is not None:
                self._augmenter.set_pool(kind, pool)
        self._rows = 0
        self._prefetch = None
        self._start_prefetch(kinds)

    def _start_prefetch(self, kinds: List[str]) -> None:
        import threading

        box = {"pools": {}, "errors": {}, "thread": None}

        def work():
            for kind in kinds:
                try:
                    box["pools"][kind] = self._read_shard(kind)
                except Exception as e:  # surfaced at swap time
                    box["errors"][kind] = e

        box["thread"] = threading.Thread(target=work, daemon=True)
        box["thread"].start()
        self._prefetch = box

    @property
    def augmenter(self):
        """The batched policy on the device (one call per bucket); pools
        are uploaded to the device on first use and reused.  Returned behind
        a thin proxy that counts augmented rows and rotates corpus shards
        (see `load`)."""
        if getattr(self, "_augmenter", None) is None:
            from pkr_tpu_torch.data.augment import WavAugmenter

            self._augmenter = WavAugmenter(
                noise=self.pools.get("noise"), music=self.pools.get("music"),
                speech=self.pools.get("babble"), rirs=self.rirs,
                seed=int(self.rng.integers(2 ** 31)),
                snr=self.snr, rvb_noise=self.rvb_noise,
                reverb_planner=self.reverb_planner, device=self.device)
            self._proxy = _RotatingAugmenter(self)
        return self._proxy

    def apply(self, wav: np.ndarray, length: int, kind: str) -> np.ndarray:
        """Apply one augmentation kind to one waveform (B=1 batched path)."""
        if kind in ("none", ""):
            return wav
        out = self.augmenter(np.asarray(wav, np.float32)[None, :],
                             np.asarray([length]), kinds=[kind])
        return out[0]


class _RotatingAugmenter:
    """WavAugmenter proxy: counts augmented rows and swaps corpus shards
    in between batches (AugmentPools.load's rotation contract).  Attribute
    access falls through to the underlying augmenter, so call sites that
    poke SNR grids or pools see the real object."""

    def __init__(self, pools: AugmentPools):
        self._pools = pools

    def __call__(self, wavs, lengths, kinds=None, device_out: bool = False):
        self._pools._maybe_rotate()
        out = self._pools._augmenter(wavs, lengths, kinds=kinds,
                                     device_out=device_out)
        self._pools._rows += len(wavs)
        return out

    def __getattr__(self, name):
        return getattr(self._pools._augmenter, name)
