"""RIRS_NOISES-style RIR / room / noise set machinery (host code).

Port of ``pkr_tpu/recipes/rir.py``; wavs are read through
``pkr_tpu_torch.io.wav``.  It replaces the list-parsing and per-recording
draw logic of steps/data/reverberate_data_dir.py — ParseSetParameterStrings /
SmoothProbabilityDistribution (:483-523), ParseRirList (:525-545),
MakeRoomDict (:553-569), ParseNoiseList (:572-610) and the draw structure of
GenerateReverberationOpts (:239-297) — with a host-side planner whose draws
feed pkr_tpu_torch.data.augment.WavAugmenter's batched reverb branch on
the card.

Semantics preserved:
- each ``--rir-set-parameters``-style entry is ``[prob,] rir_list_path``;
  unspecified probabilities are filled uniformly with the leftover mass and
  the whole set is normalized (SmoothProbabilityDistribution);
- rir_list lines are argparse-style records
  (``--rir-id .. --room-id .. [--probability p] path.wav``); within a set,
  per-RIR probabilities are smoothed to sum to the set's probability;
- the room is drawn with probability = the sum of its RIRs' probabilities,
  then the RIR within the room by its own probability
  (PickItemWithProbability applied to MakeRoomDict then room.rir_list) —
  jointly identical to drawing the RIR directly by its global probability,
  which is how the planner implements it; the room becomes relevant again
  for isotropic-noise linkage (iso noises attach to the DRAWN RIR's room,
  GenerateReverberationOpts :265-268);
- noise_list records carry ``--noise-type isotropic|point-source``,
  ``--bg-fg-type``, ``--room-linkage`` (iso only); background noises start
  at 0 and are extended (circularly) over the whole speech, foreground
  noises keep their own duration at a random start time
  (AddPointSourceNoise :219-227); fg/bg SNRs come from cyclic lists
  (list_cyclic_iterator, :333-334).

Point-source noises are convolved with an RIR drawn from the SAME room
(by within-room RIR probability) before mixing, exactly as
AddPointSourceNoise does (:215-226); each noise tuple carries its noise-RIR
pool index and the device branch applies the convolution.  Isotropic noises
are room recordings already and mix unconvolved, as in the reference.
``room_convolve_noises=False`` restores the dry mix (cheaper; irrelevant to
the VoxCeleb recipe, whose run.sh:109-110 reverberates with no additive
noises).
"""

from __future__ import annotations

import os
import shlex
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class RirEntry:
    rir_id: str
    room_id: str
    path: str                      # wav path (pipes allowed, io.wav handles)
    probability: Optional[float] = None


@dataclass
class NoiseEntry:
    noise_id: str
    noise_type: str                # 'isotropic' | 'point-source'
    path: str
    bg_fg_type: str = "background"
    room_linkage: Optional[str] = None
    probability: Optional[float] = None


def smooth_probabilities(items: list, target_sum: float = 1.0) -> list:
    """SmoothProbabilityDistribution (reverberate_data_dir.py:483-513) with
    smoothing_weight=0 (the script's default on every call site): items
    without a probability share the leftover mass uniformly, then the whole
    list is normalized to target_sum."""
    if not items:
        return items
    acc = sum(i.probability for i in items if i.probability is not None)
    n_unspec = sum(1 for i in items if i.probability is None)
    uniform = (1.0 - acc) / n_unspec if n_unspec and acc < 1.0 else 0.0
    for i in items:
        if i.probability is None:
            i.probability = uniform
    total = sum(i.probability for i in items) or 1.0
    for i in items:
        i.probability = i.probability / total * target_sum
    return items


def _parse_set_parameters(set_para: str) -> Tuple[Optional[float], str]:
    """'0.5, path' or 'path' (ParseSetParameterStrings :516-523)."""
    parts = set_para.split(",")
    if len(parts) == 2:
        return float(parts[0]), parts[1].strip()
    return None, parts[0].strip()


@dataclass
class _Set:
    filename: str
    probability: Optional[float] = None


def _resolve(path: str, base_dir: Optional[str]) -> str:
    """rir_list records usually say 'RIRS_NOISES/simulated_rirs/...' relative
    to the directory CONTAINING the RIRS_NOISES tree; resolve against the
    list's base dir and its parent so both layouts work."""
    if os.path.isabs(path) or os.path.exists(path) or base_dir is None:
        return path
    for root in (base_dir, os.path.dirname(base_dir)):
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            return cand
        # strip a leading 'RIRS_NOISES/'-style component already in root
        head = os.path.basename(root.rstrip("/"))
        if path.startswith(head + "/"):
            cand = os.path.join(os.path.dirname(root), path)
            if os.path.exists(cand):
                return cand
    return path


def _parse_record(tokens: List[str]) -> Dict[str, str]:
    """argparse-style '--key value ... positional' record line."""
    out: Dict[str, str] = {}
    pos = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t.startswith("--"):
            if i + 1 >= len(tokens):
                raise ValueError(
                    f"malformed record: flag {t!r} has no value in "
                    f"{' '.join(tokens)!r}")
            key = t[2:].replace("-", "_")
            out[key] = tokens[i + 1]
            i += 2
        else:
            pos.append(t)
            i += 1
    out["_positional"] = " ".join(pos)
    return out


def parse_rir_list(set_params: Sequence[str],
                   base_dir: Optional[str] = None) -> List[RirEntry]:
    """ParseRirList (:525-545): parse each set's rir_list file, smooth
    per-RIR probabilities to the set's probability, concatenate."""
    sets = smooth_probabilities(
        [_Set(filename=f, probability=p)
         for p, f in (_parse_set_parameters(s) for s in set_params)])
    rirs: List[RirEntry] = []
    for st in sets:
        cur = []
        with open(st.filename) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = _parse_record(shlex.split(line.strip()))
                cur.append(RirEntry(
                    rir_id=rec["rir_id"], room_id=rec["room_id"],
                    path=_resolve(rec["_positional"], base_dir),
                    probability=(float(rec["probability"])
                                 if "probability" in rec else None)))
        rirs += smooth_probabilities(cur, target_sum=st.probability)
    return rirs


def parse_noise_list(set_params: Sequence[str],
                     base_dir: Optional[str] = None
                     ) -> Tuple[List[NoiseEntry], Dict[str, List[NoiseEntry]]]:
    """ParseNoiseList (:572-610) → (point-source list, iso dict by room).
    Point-source noises are smoothed per set; isotropic noises are smoothed
    within each room's list (the script smooths iso noises per room when
    building iso_noise_dict)."""
    sets = smooth_probabilities(
        [_Set(filename=f, probability=p)
         for p, f in (_parse_set_parameters(s) for s in set_params)])
    point: List[NoiseEntry] = []
    iso: Dict[str, List[NoiseEntry]] = {}
    for st in sets:
        cur_point = []
        with open(st.filename) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = _parse_record(shlex.split(line.strip()))
                e = NoiseEntry(
                    noise_id=rec["noise_id"], noise_type=rec["noise_type"],
                    path=_resolve(rec["_positional"], base_dir),
                    bg_fg_type=rec.get("bg_fg_type", "background"),
                    room_linkage=rec.get("room_linkage"),
                    probability=(float(rec["probability"])
                                 if "probability" in rec else None))
                if e.noise_type == "isotropic":
                    if e.room_linkage is None:
                        raise ValueError(
                            f"isotropic noise {e.noise_id} needs --room-linkage")
                    iso.setdefault(e.room_linkage, []).append(e)
                else:
                    cur_point.append(e)
        point += smooth_probabilities(cur_point, target_sum=st.probability)
    point = smooth_probabilities(point)
    for room in iso:
        iso[room] = smooth_probabilities(iso[room])
    return point, iso


def find_rir_sets(rir_dir: str) -> List[str]:
    """Locate rir_list files under a RIRS_NOISES-style tree.  Prefers the
    reference recipe's smallroom+mediumroom split at equal probability
    (run.sh:105-107); otherwise every rir_list found gets uniform mass."""
    pref = [os.path.join(rir_dir, "simulated_rirs", r, "rir_list")
            for r in ("smallroom", "mediumroom")]
    if all(os.path.isfile(p) for p in pref):
        return [f"0.5, {p}" for p in pref]
    found = []
    for root, _dirs, files in os.walk(rir_dir):
        if "rir_list" in files:
            found.append(os.path.join(root, "rir_list"))
    if not found:
        raise FileNotFoundError(f"no rir_list files under {rir_dir}")
    return sorted(found)


@dataclass
class ReverbPlan:
    """One utterance's draw: RIR index into the loaded pool + up to K
    additive noises (index into the noise pool, SNR dB, start sample in the
    SIGNAL, duration in samples, noise-RIR index; duration<0 = extend over
    the whole signal; noise-RIR<0 = mix dry — isotropic noises and the
    room_convolve_noises=False regime)."""
    rir: int
    noises: List[Tuple[int, float, int, int, int]] = field(
        default_factory=list)


class ReverbPlanner:
    """Per-utterance draw engine (GenerateReverberationOpts :239-297).

    Loads (a subsample of) the RIR wavs once; draw() returns a ReverbPlan
    whose indices refer to the loaded pools (rir_pool / noise_pool), ready
    for WavAugmenter.

    max_rirs bounds the pool's device memory: when the set is larger, a
    probability-weighted subsample is drawn ONCE (room structure preserved by sampling whole
    rooms' entries with their probabilities); the draw distribution over the
    retained RIRs is renormalized.  RIRS_NOISES smallroom+mediumroom is
    40k RIRs — at 16 kHz / 1 s that would be 2.6 GB of pool; a few thousand
    RIRs are statistically indistinguishable for augmentation.
    """

    def __init__(self, rirs: List[RirEntry],
                 point_noises: Optional[List[NoiseEntry]] = None,
                 iso_noises: Optional[Dict[str, List[NoiseEntry]]] = None,
                 foreground_snrs: Sequence[float] = (20.0,),
                 background_snrs: Sequence[float] = (20.0,),
                 speech_rvb_probability: float = 1.0,
                 pointsource_noise_addition_probability: float = 1.0,
                 isotropic_noise_addition_probability: float = 1.0,
                 max_noises_per_minute: float = 1.0,
                 max_rirs: int = 4096, seed: int = 0, rate: int = 16000,
                 room_convolve_noises: bool = True):
        self.rng = np.random.default_rng(seed)
        if len(rirs) > max_rirs:
            p = np.asarray([r.probability for r in rirs])
            # smooth_probabilities can legitimately assign exactly-0 weight
            # (user-specified probs summing >= 1 zero out the unspecified
            # entries, matching the reference's warning case); choice() with
            # replace=False raises when fewer than `size` entries have
            # nonzero probability, so cap the subsample at that count.
            n_pick = min(max_rirs, int(np.count_nonzero(p)))
            keep = self.rng.choice(len(rirs), size=n_pick, replace=False,
                                   p=p / p.sum())
            rirs = [rirs[i] for i in sorted(keep)]
        self.rirs = smooth_probabilities(rirs)
        self.rir_probs = np.asarray([r.probability for r in self.rirs])
        self.rir_rooms = [r.room_id for r in self.rirs]
        self.room_convolve_noises = room_convolve_noises
        # room -> (rir pool indices, within-room draw probabilities): the
        # noise-RIR draw in AddPointSourceNoise (:215) picks from
        # room.rir_list by RIR probability
        self._room_rirs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for room in set(self.rir_rooms):
            idx = np.asarray([i for i, r in enumerate(self.rir_rooms)
                              if r == room])
            p = self.rir_probs[idx]
            if p.sum() == 0:
                # a room whose RIRs all carry exactly-0 probability (the
                # smooth_probabilities user-sum>=1 case) is unreachable from
                # the speech-RIR draw — skip it instead of building a NaN
                # probability array
                continue
            self._room_rirs[room] = (idx, p / p.sum())
        self.point_noises = point_noises or []
        self.point_probs = (np.asarray([n.probability
                                        for n in self.point_noises])
                            if self.point_noises else None)
        self.iso_noises = iso_noises or {}
        self.fg_snrs = list(foreground_snrs)
        self.bg_snrs = list(background_snrs)
        self._fg_i = 0
        self._bg_i = 0
        self.speech_rvb_probability = speech_rvb_probability
        self.point_prob = pointsource_noise_addition_probability
        self.iso_prob = isotropic_noise_addition_probability
        self.max_noises_per_minute = max_noises_per_minute
        self.rate = rate
        self.cap_hits = 0  # utterances whose noise draw hit max_slots
        # noise pool index: point-source noises first, then iso noises in
        # room order (one flat pool for the device side)
        self._noise_entries: List[NoiseEntry] = list(self.point_noises)
        self._iso_index: Dict[str, List[int]] = {}
        for room in sorted(self.iso_noises):
            self._iso_index[room] = []
            for e in self.iso_noises[room]:
                self._iso_index[room].append(len(self._noise_entries))
                self._noise_entries.append(e)

    def _next_fg(self) -> float:
        v = self.fg_snrs[self._fg_i % len(self.fg_snrs)]
        self._fg_i += 1
        return v

    def _next_bg(self) -> float:
        v = self.bg_snrs[self._bg_i % len(self.bg_snrs)]
        self._bg_i += 1
        return v

    @property
    def noise_entries(self) -> List[NoiseEntry]:
        return self._noise_entries

    def draw(self, n_samples: int,
             noise_lens: Optional[np.ndarray] = None,
             max_slots: Optional[int] = None) -> Optional[ReverbPlan]:
        """One utterance's plan; None = leave the utterance dry (the
        speech_rvb_probability miss with no noises drawn).  noise_lens: true
        pool lengths (samples), needed to size foreground windows.

        max_slots caps the number of noises drawn (the device-side mix has a
        fixed slot count).  The cap is enforced HERE, before the cyclic
        fg/bg SNR iterators advance, so a bound cap can't drift the SNR
        cycle for later utterances; cap_hits counts utterances where it
        bound (the composed mix then has fewer noises than
        reverberate_data_dir.py:216-226 would apply — observable, not
        silent)."""
        # the room/RIR joint draw: direct draw by global probability is
        # identical to room-then-RIR (see module docstring)
        ridx = int(self.rng.choice(len(self.rirs),
                                   p=self.rir_probs / self.rir_probs.sum()))
        apply_rir = self.rng.random() < self.speech_rvb_probability
        noises: List[Tuple[int, float, int, int, int]] = []
        room = self.rir_rooms[ridx]
        iso_list = self._iso_index.get(room, [])
        if iso_list and self.rng.random() < self.iso_prob:
            probs = np.asarray([self._noise_entries[i].probability
                                for i in iso_list])
            pick = int(self.rng.choice(iso_list, p=probs / probs.sum()))
            # iso noise: start 0, extended over the whole speech, bg SNR,
            # never room-convolved (it IS a room recording)
            noises.append((pick, self._next_bg(), 0, -1, -1))
        dur_sec = n_samples / self.rate
        max_noises = int(self.max_noises_per_minute * dur_sec / 60.0)
        if (self.point_noises and max_noises >= 1
                and self.rng.random() < self.point_prob):
            for _ in range(int(self.rng.integers(1, max_noises + 1))):
                if max_slots is not None and len(noises) >= max_slots:
                    self.cap_hits += 1
                    break
                pick = int(self.rng.choice(
                    len(self.point_noises),
                    p=self.point_probs / self.point_probs.sum()))
                e = self.point_noises[pick]
                # the noise's RIR: drawn from the SAME room as the speech
                # RIR, by within-room probability (AddPointSourceNoise :215)
                nrir = -1
                if self.room_convolve_noises:
                    r_idx, r_p = self._room_rirs[room]
                    nrir = int(self.rng.choice(r_idx, p=r_p))
                if e.bg_fg_type == "background":
                    noises.append((pick, self._next_bg(), 0, -1, nrir))
                else:
                    start = int(self.rng.random() * n_samples)
                    dur = n_samples - start
                    if noise_lens is not None:
                        dur = min(dur, int(noise_lens[pick]))
                    noises.append((pick, self._next_fg(), start, dur, nrir))
        if not apply_rir and not noises:
            return None
        return ReverbPlan(rir=ridx if apply_rir else -1, noises=noises)


def load_pool_wavs(paths: Sequence[str], max_len_sec: float,
                   rate: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
    """Read wavs into a padded (K, L) pool + true lengths."""
    from pkr_tpu_torch.io.wav import read_wav
    from pkr_tpu_torch.recipes.augment_dir import AugmentPools

    wavs = []
    for p in paths:
        w, r = read_wav(p)
        if r != rate:
            raise ValueError(f"{p}: {r} Hz, the pool expects {rate}")
        wavs.append(w)
    return AugmentPools.from_wavs(wavs, int(max_len_sec * rate))
