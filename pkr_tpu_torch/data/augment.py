"""Waveform augmentation on the card: additive noise / music / babble at an
exact SNR, RIR reverberation, speed perturbation.

Port of ``pkr_tpu/data/augment.py``.  The reference recipe rewrites wav.scp
entries into ``wav-reverberate`` pipes run per utterance
(steps/data/augment_data_dir.py + reverberate_data_dir.py); here the pools
live on the card and a whole bucket is mixed right before the frontend, so
augmented features never touch the disk.

Semantics kept from wav-reverberate:
- additive signals are tiled/cropped to the target length at a random start
  offset and scaled to an exact SNR in dB against the signal energy
  (run.sh:136-144 SNR grids: noise 15:10:5:0, music 15:10:8:5,
  babble 20:17:15:13, babble mixes 3-7 speech sources);
- RIR convolution via rFFT (``torch.fft``), output shifted so the direct
  path (RIR peak) stays time-aligned (--shift-output=true) and
  power-normalized to the dry signal's energy (--normalize-output);
- speed perturbation by sox-style resampling (factors 0.9/1.0/1.1,
  utils/perturb_data_dir_speed.sh) as linear interpolation, on the host.

Every random draw (kinds, sources, starts, SNRs, the reverb planner's) is a
numpy ``default_rng`` draw made in the reference's order, so one seed gives
``pkr_tpu``'s plans; only the small plan vectors go to the card per batch.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, as_device_tensor, resolve_device


def _energy(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Σ x² over the first ``length`` samples of each row: x (B, n), length (B,)."""
    mask = torch.arange(x.shape[-1], device=x.device) < length[..., None]
    return torch.sum((x * mask) ** 2, dim=-1)


def _batch(x: torch.Tensor, *per_row):
    """A 1-D signal as a one-row batch, and the per-row values as (B,)
    tensors on its device; returns (x, per_row, whether to squeeze)."""
    one = x.ndim == 1
    vals = [torch.as_tensor(v, device=x.device).reshape(-1) for v in per_row]
    return (x[None] if one else x), vals, one


def add_noise_snr(signal: torch.Tensor, sig_len: torch.Tensor,
                  noise: torch.Tensor, noise_len: torch.Tensor,
                  snr_db: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Mix one noise source into each signal at an exact SNR.

    signal (B, n) or (n,), noise (B, M) or (M,), the rest (B,) or scalars;
    the noise is read circularly from ``start`` so any offset and length
    work."""
    signal, (sig_len, noise_len, snr_db, start), one = _batch(
        signal, sig_len, noise_len, snr_db, start)
    noise = noise.expand(signal.shape[0], -1) if noise.ndim == 1 else noise
    n = signal.shape[-1]
    idx = (start[:, None] + torch.arange(n, device=signal.device)) \
        % torch.clamp(noise_len, min=1)[:, None]
    tiled = torch.gather(noise, 1, idx.to(torch.int64))
    e_sig = torch.clamp(_energy(signal, sig_len), min=1e-10)
    e_noise = torch.clamp(_energy(tiled, sig_len), min=1e-10)
    scale = torch.sqrt(e_sig / (e_noise * 10.0 ** (snr_db / 10.0)))
    mask = torch.arange(n, device=signal.device) < sig_len[:, None]
    out = signal + scale[:, None] * tiled * mask
    return out[0] if one else out


def reverberate(signal: torch.Tensor, sig_len: torch.Tensor,
                rir: torch.Tensor, rir_len: torch.Tensor) -> torch.Tensor:
    """FFT convolution with an impulse response per row; direct-path aligned
    and power-normalized (wav-reverberate --shift-output --normalize-output).

    signal (B, n) or (n,), rir (B, m) or (m,) zero-padded, lengths (B,).
    The FFT size is the next power of two ≥ n + m, m the padded width (as
    the reference sizes it from static shapes)."""
    signal, (sig_len, rir_len), one = _batch(signal, sig_len, rir_len)
    rir = rir.expand(signal.shape[0], -1) if rir.ndim == 1 else rir
    n, m = signal.shape[-1], rir.shape[-1]
    fft_n = 1
    while fft_n < n + m:
        fft_n *= 2
    rir = rir * (torch.arange(m, device=rir.device) < rir_len[:, None])
    spec = torch.fft.rfft(signal, fft_n) * torch.fft.rfft(rir, fft_n)
    wet_full = torch.fft.irfft(spec, fft_n)
    # shift so the RIR's peak (direct path; the first maximum) maps t→t
    peak = torch.argmax(torch.abs(rir), dim=-1)
    ar = torch.arange(n, device=signal.device)
    wet = torch.gather(wet_full, 1, peak[:, None] + ar)
    e_dry = torch.clamp(_energy(signal, sig_len), min=1e-10)
    e_wet = torch.clamp(_energy(wet, sig_len), min=1e-10)
    out = wet * torch.sqrt(e_dry / e_wet)[:, None]
    out = out * (ar < sig_len[:, None])
    return out[0] if one else out


def speed_perturb(signal: np.ndarray, factor: float) -> np.ndarray:
    """sox speed semantics: playback-rate change (resample, new length
    n/factor) by linear interpolation.  Host-side numpy: this runs once per
    utterance as it is decoded."""
    n = len(signal)
    new_n = int(round(n / factor))
    pos = np.arange(new_n) * factor
    i0 = np.clip(pos.astype(np.int64), 0, n - 1)
    i1 = np.clip(i0 + 1, 0, n - 1)
    frac = (pos - i0).astype(signal.dtype)
    return signal[i0] * (1 - frac) + signal[i1] * frac


_TILE_ROWS = 64  # rows tiled per gather: bounds its int64 index tensor


def tile_pool(mats: torch.Tensor, lens: torch.Tensor, n: int) -> torch.Tensor:
    """Circularly extend each pool row to L+n samples so that ANY circular
    window [start, start+n) with start < row_len is one contiguous slice.
    A zero-length row reads its first sample (the index is taken modulo
    max(len, 1))."""
    K, L = mats.shape
    idx = torch.arange(L + n, device=mats.device)
    out = torch.empty((K, L + n), dtype=mats.dtype, device=mats.device)
    lens = lens.to(mats.device)
    for r0 in range(0, K, _TILE_ROWS):
        sl = slice(r0, r0 + _TILE_ROWS)
        out[sl] = torch.gather(mats[sl], 1, idx[None, :] % torch.clamp(lens[sl], min=1)[:, None])
    return out


def _windows(tiled: torch.Tensor, src: torch.Tensor, start: torch.Tensor,
             n: int) -> torch.Tensor:
    """Rows tiled[src, start:start+n] as one gather.  Like the reference's
    ``dynamic_slice``, the source row and the start are clamped so that the
    window fits."""
    K, W = tiled.shape
    src = torch.clamp(src.to(torch.int64), 0, K - 1)
    start = torch.clamp(start.to(torch.int64), 0, W - n)
    return tiled[src[:, None], start[:, None] + torch.arange(n, device=tiled.device)]


class WavAugmenter:
    """Random augmentation policy over a batch, reference SNR grids.

    Draws one of {none, noise, music, babble, reverb} per utterance
    (augment_data_dir.py composes a 2x corpus: clean + one augmentation each;
    run.sh:162-164) and applies it on the card.  The pools are uploaded
    once; per batch the host only ships the small plan vectors (kind, source
    index, SNR, start).  Rows are grouped by kind and each group's branch
    runs once, batched; clean rows come back bit-identical.

    Babble semantics match wav-reverberate: each of the 3-7 speech sources
    is mixed at its own grid SNR measured against the CLEAN signal — no
    aggregate-SNR compensation.
    """

    SNR = {"noise": (15.0, 10.0, 5.0, 0.0),
           "music": (15.0, 10.0, 8.0, 5.0),
           "babble": (20.0, 17.0, 15.0, 13.0)}
    MAX_BABBLE = 7

    def __init__(self, noise: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 music: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 speech: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 rirs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 seed: int = 0, snr: Optional[dict] = None,
                 rvb_noise: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 reverb_planner=None, device: DeviceLike = None):
        """Each pool is (padded matrix (K, L), lengths (K,)).  `snr`
        overrides the per-kind SNR grids (DataConfig.snr_*).

        RIR-set extensions (reverberate_data_dir.py semantics, wired by
        recipes.rir):
        - rvb_noise: a second additive pool reserved for noises COMPOSED
          with the reverb branch (iso/point-source RIR-set noises);
        - reverb_planner: a recipes.rir.ReverbPlanner — when set, each
          'reverb' row's RIR + noise draw comes from planner.draw()
          (room-linked iso noises, fg/bg SNR cycles, max-noises-per-minute)
          instead of a uniform RIR draw.
        `device` (None: the card) holds the pools and does the mixing.
        """
        self.device = resolve_device(device)
        if snr:
            self.SNR = {**type(self).SNR,
                        **{k: tuple(float(x) for x in v)
                           for k, v in snr.items()}}
        self.pools = {}
        self._host_lens = {}
        for name, p in (("noise", noise), ("music", music),
                        ("babble", speech), ("rvb_noise", rvb_noise)):
            if p is not None:
                self.pools[name] = self._upload(p)
                self._host_lens[name] = np.asarray(p[1], np.int64)
        self.rirs = None if rirs is None else self._upload(rirs)
        self.reverb_planner = reverb_planner
        self.rng = np.random.default_rng(seed)
        self._tiled = OrderedDict()  # (kind, n) -> tiled pool matrix, LRU
        self._tiled_bytes = 0
        self.tile_budget_bytes = 2 << 30  # device-memory ceiling for tiles

    def _upload(self, pool) -> Tuple[torch.Tensor, torch.Tensor]:
        mats, lens = pool
        return (as_device_tensor(np.asarray(mats, np.float32), self.device),
                as_device_tensor(np.asarray(lens, np.int64), self.device))

    def set_pool(self, kind: str, pool: Tuple[np.ndarray, np.ndarray]) -> None:
        """Swap a pool's backing shard (full-corpus rotation,
        recipes.augment_dir.AugmentPools.load).  The new shard keeps the
        previous shard's (K, L) shape, so the tile budget's accounting holds;
        the kind's tiles are dropped."""
        if kind not in self.pools:
            raise KeyError(kind)
        old_shape = tuple(self.pools[kind][0].shape)
        if tuple(pool[0].shape) != old_shape:
            raise ValueError(f"set_pool({kind!r}): shape {tuple(pool[0].shape)}, "
                             f"the pool has {old_shape}")
        self.pools[kind] = self._upload(pool)
        self._host_lens[kind] = np.asarray(pool[1], np.int64)
        for key in [k for k in self._tiled if k[0] == kind]:
            self._tiled_bytes -= self._tile_cost(key[0], key[1])
            del self._tiled[key]

    def _tile_cost(self, kind: str, n: int) -> int:
        mats = self.pools[kind][0]
        return int(mats.shape[0] * (mats.shape[1] + n) * 4)

    def kinds(self):
        out = [k for k in self.pools if k != "rvb_noise"]
        if self.rirs is not None:
            out.append("reverb")
        return out

    def _tiled_pool(self, kind: str, n: int) -> torch.Tensor:
        """Byte-accounted LRU over the tiled pool copies: evict the
        least-recently-used tiles until the new one fits under
        tile_budget_bytes."""
        key = (kind, n)
        if key in self._tiled:
            self._tiled.move_to_end(key)
            return self._tiled[key]
        cost = self._tile_cost(kind, n)
        while self._tiled and self._tiled_bytes + cost > self.tile_budget_bytes:
            old_key, _ = self._tiled.popitem(last=False)
            self._tiled_bytes -= self._tile_cost(old_key[0], old_key[1])
        mats, lens = self.pools[kind]
        self._tiled[key] = tile_pool(mats, lens, n)
        self._tiled_bytes += cost
        return self._tiled[key]

    def _draw_plan(self, codes: np.ndarray, names, lengths: np.ndarray):
        """Host-side plan vectors for one batch:
        (src, starts, snrs, sig_starts, durs, nrirs, n_src)."""
        B = len(codes)
        S = self.MAX_BABBLE
        src = np.zeros((B, S), np.int32)
        starts = np.zeros((B, S), np.int32)
        snrs = np.zeros((B, S), np.float32)
        sig_starts = np.zeros((B, S), np.int32)
        durs = np.full((B, S), -1, np.int32)
        nrirs = np.full((B, S), -1, np.int32)  # noise-RIR index; -1 = dry
        n_src = np.ones(B, np.int32)
        for ci, name in enumerate(names):
            rows = np.where(codes == ci + 1)[0]
            if rows.size == 0:
                continue
            if name == "reverb":
                n_rirs = len(self.rirs[1])
                if self.reverb_planner is not None:
                    nl = self._host_lens.get("rvb_noise")
                    for r in rows:
                        # slot cap passed into the draw so the planner's
                        # cyclic SNR iterators never advance for noises the
                        # S-slot mix couldn't hold (planner.cap_hits counts
                        # utterances where the cap bound)
                        plan = self.reverb_planner.draw(int(lengths[r]), nl,
                                                        max_slots=S - 1)
                        if plan is None:  # dry: delta RIR, no noises
                            src[r, 0] = n_rirs - 1
                            continue
                        # rir=-1 (noises only) → the delta-RIR identity row
                        # appended by recipes.augment_dir (index K-1)
                        src[r, 0] = plan.rir if plan.rir >= 0 else n_rirs - 1
                        if len(plan.noises) > S - 1:
                            raise RuntimeError(f"the planner drew {len(plan.noises)} "
                                               f"noises for {S - 1} slots")
                        for i, (ni, snr, s0, d, nrir) in enumerate(
                                plan.noises, start=1):
                            src[r, i] = ni
                            snrs[r, i] = snr
                            sig_starts[r, i] = s0
                            durs[r, i] = d
                            nrirs[r, i] = nrir
                            # align the tiled row so that tiled[start+t] =
                            # noise[(t - s0) mod len]
                            L = max(int(nl[ni]), 1) if nl is not None else 1
                            starts[r, i] = (L - s0 % L) % L
                        n_src[r] = 1 + len(plan.noises)
                else:
                    src[rows, 0] = self.rng.integers(0, n_rirs, rows.size)
                continue
            lens = self._host_lens[name]
            cols = S if name == "babble" else 1
            if name == "babble":
                n_src[rows] = self.rng.integers(3, 8, rows.size)
            k = self.rng.integers(0, len(lens), (rows.size, cols)).astype(np.int32)
            src[rows, :cols] = k
            starts[rows, :cols] = self.rng.integers(
                0, np.maximum(lens[k], 1)).astype(np.int32)
            snrs[rows, :cols] = self.rng.choice(self.SNR[name],
                                                (rows.size, cols))
        return src, starts, snrs, sig_starts, durs, nrirs, n_src

    # --- the branches, each on one group of rows -------------------------
    # `p` holds the group's plan on the device; `slots` lists, per noise or
    # babble slot i, (i, the group's rows that use it, of those the rows
    # whose noise is room-convolved), worked out on the host from the plan

    def _to_device(self, arrays, dtype):
        """Host arrays → device tensors of `dtype` in one copy: packed into
        one buffer, pinned and copied without blocking the host on the
        card, so the augmenter never waits for the card's earlier work."""
        flat = np.concatenate([np.asarray(a).ravel() for a in arrays]).astype(dtype)
        buf = torch.from_numpy(flat)
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        out, o = [], 0
        for a in arrays:
            out.append(buf[o:o + a.size].view(a.shape))
            o += a.size
        return out

    @staticmethod
    def _scaled(tiled, src, start, snr, e_sig, length, n):
        t = _windows(tiled, src, start, n)
        e_n = torch.clamp(_energy(t, length), min=1e-10)
        return torch.sqrt(e_sig / (e_n * 10.0 ** (snr / 10.0)))[:, None] * t

    def _additive(self, kind, sig, length, mask, e_sig, p, slots):
        n = sig.shape[1]
        t = self._scaled(self._tiled_pool(kind, n), p["src"][:, 0], p["starts"][:, 0],
                         p["snrs"][:, 0], e_sig, length, n)
        return sig + t * mask

    def _babble(self, sig, length, mask, e_sig, p, slots):
        n = sig.shape[1]
        tiled = self._tiled_pool("babble", n)
        acc = torch.zeros_like(sig)
        for i, on, _ in slots:  # a slot at i >= n_src adds zero: not run
            acc[on] += self._scaled(tiled, p["src"][on, i], p["starts"][on, i],
                                    p["snrs"][on, i], e_sig[on], length[on], n)
        return sig + acc * mask

    def _reverb(self, sig, length, mask, e_sig, p, slots):
        """wav-reverberate composition: reverberated (power-normalized)
        speech + additive RIR-set noises at their fg/bg SNRs against the
        signal's power (post-normalization wet energy == dry energy).
        Columns 1..n_src-1 of the plan hold the noises; a noise's window is
        [sig_start, sig_start+dur) — bg/iso noises get dur<0 = the whole
        utterance (circular extension = wav-reverberate --duration
        repetition), fg noises keep their own duration at a random start
        (AddPointSourceNoise :219-227)."""
        n = sig.shape[1]
        rmats, rlens = self.rirs
        r0 = p["src"][:, 0]
        wet = reverberate(sig, length, rmats[r0], rlens[r0])
        if "rvb_noise" not in self.pools or not slots:
            return wet
        tiled = self._tiled_pool("rvb_noise", n)
        ar = torch.arange(n, device=sig.device)
        p_sig = e_sig / torch.clamp(length.to(sig.dtype), min=1.0)
        acc = torch.zeros_like(sig)
        for i, on, conv in slots:
            ln = length[on]
            t = _windows(tiled, p["src"][on, i], p["starts"][on, i], n)
            s0, dur = p["sig_starts"][on, i], p["durs"][on, i]
            d = torch.where(dur < 0, ln, dur)
            w = ((ar >= s0[:, None]) & (ar < (s0 + d)[:, None])
                 & (ar < ln[:, None])).to(sig.dtype)
            if conv is not None:
                # AddPointSourceNoise (:215-226): a point-source noise is
                # reverberated with an RIR of the speech's room before the
                # mix; its power normalization cancels under the power-ratio
                # SNR scale below.  The conv input is WINDOWED first (t·w):
                # a fg noise at start s0 must echo its own clip, not the
                # circular tail before s0; the re-window below truncates the
                # tail.  nrir<0 (iso noises, dry regime) keeps the raw row.
                k = p["nrirs"][on[conv], i]
                t[conv] = reverberate(t[conv] * w[conv], ln[conv], rmats[k], rlens[k])
            # wav-reverberate AddNoise scales by the POWER (mean-square)
            # ratio over each signal's own duration
            n_w = torch.clamp(torch.sum(w, dim=-1), min=1.0)
            p_n = torch.clamp(torch.sum((t * w) ** 2, dim=-1) / n_w, min=1e-10)
            scale = torch.sqrt(p_sig[on] / (p_n * 10.0 ** (p["snrs"][on, i] / 10.0)))
            acc[on] += scale[:, None] * t * w
        return wet + acc

    def _slots(self, name, h):
        """(i, rows of the group that use slot i, of those the rows whose
        noise is room-convolved or None) for a group's host plan `h`."""
        if name not in ("babble", "reverb"):
            return []
        noise_conv = (name == "reverb" and self.reverb_planner is not None
                      and getattr(self.reverb_planner, "room_convolve_noises", False))
        out = []
        for i in range(0 if name == "babble" else 1, self.MAX_BABBLE):
            on = np.nonzero(h["n_src"] > i)[0]
            if on.size == 0:
                continue
            conv = np.nonzero(h["nrirs"][on, i] >= 0)[0] if noise_conv else np.zeros(0)
            out.append((i, on, conv if conv.size else None))
        return out

    def __call__(self, wavs, lengths: np.ndarray, kinds=None,
                 device_out: bool = False):
        """Augment a (B, N) batch; one kind per row.

        kinds: optional per-row kind names ('none' = keep clean), e.g. from a
        utt2aug table; drawn uniformly over {clean} + available kinds when
        absent.  Unavailable kinds (no pool loaded) pass through clean.
        lengths are host integers (the plans are drawn from them).
        device_out=True returns the tensor on the device without a copy to
        the host — for a result that feeds the frontend; otherwise numpy."""
        names = self.kinds()
        x = as_device_tensor(wavs, self.device, torch.float32)
        B, n = x.shape
        codes = None
        if names:
            if kinds is None:
                draw = self.rng.integers(0, len(names) + 1, size=B)
                codes = np.where(draw == len(names), 0, draw + 1).astype(np.int32)
            else:
                code_of = {k: i + 1 for i, k in enumerate(names)}
                codes = np.asarray([code_of.get(k, 0) for k in kinds], np.int32)
        if codes is None or not codes.any():
            return x if device_out else x.cpu().numpy()
        lengths = np.asarray(lengths)
        plan = dict(zip(("src", "starts", "snrs", "sig_starts", "durs", "nrirs", "n_src"),
                        self._draw_plan(codes, names, lengths)))
        # the host's side of each group: its rows and its slots' rows
        groups = []
        for ci, name in enumerate(names):
            rows = np.nonzero(codes == ci + 1)[0]
            if rows.size:
                groups.append((name, rows, self._slots(
                    name, {k: plan[k][rows] for k in ("n_src", "nrirs")})))
        keys = ("src", "starts", "sig_starts", "durs", "nrirs")
        ints = [lengths] + [plan[k] for k in keys]
        for _, rows, slots in groups:
            ints.append(rows)
            for _, on, conv in slots:
                ints += [on] + ([] if conv is None else [conv])
        ints = iter(self._to_device(ints, np.int64))
        snrs_all, = self._to_device([plan["snrs"]], np.float32)
        length_all = next(ints)
        plan_dev = {k: next(ints) for k in keys}
        plan_dev["snrs"] = snrs_all
        # a copy: clean rows keep the input's bits, and the caller's array
        # (which a CPU tensor may share) is never written
        out = x.clone()
        branch = {"babble": self._babble, "reverb": self._reverb}
        ar = torch.arange(n, device=self.device)
        for name, _, slots in groups:
            rows = next(ints)
            slots = [(i, next(ints), None if conv is None else next(ints))
                     for i, _, conv in slots]
            p = {k: v[rows] for k, v in plan_dev.items()}
            sig, length = x[rows], length_all[rows]
            mask = (ar < length[:, None]).to(sig.dtype)
            e_sig = torch.clamp(_energy(sig, length), min=1e-10)
            fn = branch.get(name, functools.partial(self._additive, name))
            out[rows] = fn(sig, length, mask, e_sig, p, slots)
        return out if device_out else out.cpu().numpy()
