"""The Kaldi "data directory" model as a typed Python object.

A copy of ``pkr_tpu/io/datadir.py`` for the port, which imports nothing
of ``pkr_tpu``.

The reference's universal interface between stages is a directory of sorted,
string-keyed text tables: wav.scp, utt2spk, spk2utt, feats.scp, vad.scp,
utt2num_frames, segments, trials (SURVEY.md §2.8).  The ~40 shell/Perl tools
that create/repair/subset these (utils/fix_data_dir.sh, validate_data_dir.sh,
filter_scp.pl, split_scp.pl, subset_data_dir.sh, combine_data.sh,
utt2spk_to_spk2utt.pl, ...) collapse into this one module.

Design: a ``DataDir`` is an in-memory dict-of-dicts with explicit load/save;
all operations are pure (return new objects).  Consistency repair follows
fix_data_dir.sh semantics: intersect keys across present tables, keep sorted
order, and regenerate spk2utt from utt2spk.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# tables keyed by utterance-id (value = rest of the line)
_UTT_TABLES = ("wav.scp", "utt2spk", "feats.scp", "vad.scp", "utt2num_frames",
               "utt2spkid", "utt2dur", "utt2aug", "utt2speed", "utt2warp", "text",
               "segments")
# tables keyed by speaker-id
_SPK_TABLES = ("spk2utt", "spk2gender")


def _read_table(path: str) -> Dict[str, str]:
    table: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split(None, 1)
            key = parts[0]
            val = parts[1] if len(parts) > 1 else ""
            table[key] = val
    return table


def _write_table(path: str, table: Dict[str, str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for key in sorted(table):
            val = table[key]
            f.write(f"{key} {val}\n" if val else f"{key}\n")


@dataclass
class DataDir:
    """In-memory Kaldi data directory."""

    tables: Dict[str, Dict[str, str]] = field(default_factory=dict)

    # ------------------------------------------------------------------ io
    @classmethod
    def load(cls, path: str, names: Optional[Sequence[str]] = None) -> "DataDir":
        names = names or (_UTT_TABLES + _SPK_TABLES)
        tables = {}
        for name in names:
            p = os.path.join(path, name)
            if os.path.exists(p):
                tables[name] = _read_table(p)
        return cls(tables)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for name, table in self.tables.items():
            _write_table(os.path.join(path, name), table)

    # ---------------------------------------------------------- accessors
    def __getitem__(self, name: str) -> Dict[str, str]:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables

    def get(self, name: str) -> Dict[str, str]:
        return self.tables.get(name, {})

    @property
    def utts(self) -> List[str]:
        rec_keyed = "segments" in self.tables
        for name in _UTT_TABLES:
            if name == "wav.scp" and rec_keyed:
                continue  # recording-keyed, not utterance-keyed
            if name in self.tables:
                return sorted(self.tables[name])
        return []

    @property
    def spks(self) -> List[str]:
        if "utt2spk" in self.tables:
            return sorted(set(self.tables["utt2spk"].values()))
        return sorted(self.tables.get("spk2utt", {}))

    @property
    def num_utts(self) -> int:
        return len(self.utts)

    # --------------------------------------------------------- operations
    def make_spk2utt(self) -> "DataDir":
        """Regenerate spk2utt from utt2spk (utt2spk_to_spk2utt.pl)."""
        spk2utt: Dict[str, List[str]] = {}
        for utt, spk in self.tables.get("utt2spk", {}).items():
            spk2utt.setdefault(spk, []).append(utt)
        new = dict(self.tables)
        new["spk2utt"] = {spk: " ".join(sorted(us)) for spk, us in spk2utt.items()}
        return DataDir(new)

    def validate(self, require: Sequence[str] = ("utt2spk",)) -> List[str]:
        """Return a list of consistency problems (validate_data_dir.sh
        semantics: same sorted key set across all utt-keyed tables)."""
        problems = []
        for name in require:
            if name not in self.tables:
                problems.append(f"missing table {name}")
        utt_tables = [n for n in _UTT_TABLES if n in self.tables]
        if "segments" in self.tables and "wav.scp" in utt_tables:
            # Kaldi semantics: with a segments file, wav.scp is keyed by
            # RECORDING id, not utterance id — check referenced recordings
            # exist instead of demanding utterance-key equality
            utt_tables.remove("wav.scp")
            recs = {v.split()[0] for v in self.tables["segments"].values()}
            missing_recs = recs - set(self.tables["wav.scp"])
            if missing_recs:
                problems.append(
                    f"segments references {len(missing_recs)} recordings "
                    f"absent from wav.scp")
        if utt_tables:
            ref_name = utt_tables[0]
            ref_keys = set(self.tables[ref_name])
            for name in utt_tables[1:]:
                keys = set(self.tables[name])
                if keys != ref_keys:
                    extra = len(keys - ref_keys)
                    missing = len(ref_keys - keys)
                    problems.append(
                        f"{name} inconsistent with {ref_name}: "
                        f"{extra} extra / {missing} missing keys")
        if "spk2utt" in self.tables and "utt2spk" in self.tables:
            regen = self.make_spk2utt().tables["spk2utt"]
            if regen != self.tables["spk2utt"]:
                problems.append("spk2utt inconsistent with utt2spk")
        return problems

    def fix(self) -> "DataDir":
        """Repair by intersecting utterance keys across all present utt-keyed
        tables and regenerating spk2utt (fix_data_dir.sh semantics)."""
        utt_tables = [n for n in _UTT_TABLES if n in self.tables]
        rec_keyed = "segments" in self.tables  # wav.scp keys recordings then
        if rec_keyed and "wav.scp" in utt_tables:
            utt_tables.remove("wav.scp")
        if not utt_tables:
            return self
        keep = set(self.tables[utt_tables[0]])
        for name in utt_tables[1:]:
            keep &= set(self.tables[name])
        new = {}
        for name, table in self.tables.items():
            if name == "wav.scp" and rec_keyed:
                recs = {v.split()[0]
                        for u, v in self.tables["segments"].items()
                        if u in keep}
                new[name] = {k: v for k, v in table.items() if k in recs}
            elif name in _UTT_TABLES:
                new[name] = {k: v for k, v in table.items() if k in keep}
            else:
                new[name] = dict(table)
        fixed = DataDir(new)
        if "utt2spk" in fixed.tables:
            fixed = fixed.make_spk2utt()
        return fixed

    def filter_utts(self, keep: Iterable[str]) -> "DataDir":
        """Keep only the given utterances (filter_scp.pl applied everywhere)."""
        keep = set(keep)
        rec_keyed = "segments" in self.tables
        new = {}
        for name, table in self.tables.items():
            if name == "wav.scp" and rec_keyed:
                recs = {v.split()[0]
                        for u, v in self.tables["segments"].items()
                        if u in keep}
                new[name] = {k: v for k, v in table.items() if k in recs}
            elif name in _UTT_TABLES:
                new[name] = {k: v for k, v in table.items() if k in keep}
            else:
                new[name] = dict(table)
        out = DataDir(new)
        return out.make_spk2utt() if "utt2spk" in out.tables else out

    def subset(self, n: int, first: bool = True) -> "DataDir":
        """First/last-n utterance subset (subset_data_dir.sh)."""
        utts = self.utts
        chosen = utts[:n] if first else (utts[-n:] if n > 0 else [])
        return self.filter_utts(chosen)

    def split(self, num_shards: int, shard: int) -> "DataDir":
        """Deterministic round-robin shard (split_scp.pl j/n semantics)."""
        utts = self.utts
        chosen = [u for i, u in enumerate(utts) if i % num_shards == shard]
        return self.filter_utts(chosen)

    @staticmethod
    def combine(dirs: Sequence["DataDir"]) -> "DataDir":
        """Union of several data dirs (combine_data.sh); duplicate keys keep
        the first occurrence."""
        names: List[str] = []
        for d in dirs:
            for n in d.tables:
                if n not in names:
                    names.append(n)
        new: Dict[str, Dict[str, str]] = {}
        for name in names:
            merged: Dict[str, str] = {}
            for d in dirs:
                for k, v in d.tables.get(name, {}).items():
                    merged.setdefault(k, v)
            new[name] = merged
        out = DataDir(new)
        return out.make_spk2utt() if "utt2spk" in out.tables else out

    # ----------------------------------------------------------- recipes
    def assign_spk_ids(self) -> Tuple["DataDir", int]:
        """Build utt2spkid (contiguous int labels, sorted-speaker order) —
        the awk label-assignment stage at feature_pre.sh:218-219."""
        spks = self.spks
        spk2id = {s: i for i, s in enumerate(spks)}
        utt2spkid = {u: str(spk2id[s]) for u, s in self.tables["utt2spk"].items()}
        new = dict(self.tables)
        new["utt2spkid"] = utt2spkid
        return DataDir(new), len(spks)

    def train_cv_split(self, cv_fraction: float, seed: int = 777) -> Tuple["DataDir", "DataDir"]:
        """Deterministic shuffled train/cv utterance split
        (feature_pre.sh:201-230 semantics: random split by utterance)."""
        import random

        utts = self.utts
        rng = random.Random(seed)
        shuffled = list(utts)
        rng.shuffle(shuffled)
        n_cv = int(len(shuffled) * cv_fraction)
        cv = set(shuffled[:n_cv])
        return (self.filter_utts([u for u in utts if u not in cv]),
                self.filter_utts([u for u in utts if u in cv]))

    def filter_min_frames(self, min_frames: int) -> "DataDir":
        """Drop utterances shorter than min_frames using utt2num_frames
        (the >=200-frame filter, feature_pre.sh:204)."""
        nf = self.tables.get("utt2num_frames", {})
        keep = [u for u, n in nf.items() if int(n) >= min_frames]
        return self.filter_utts(keep)


def compute_utt2dur(dd: "DataDir") -> "DataDir":
    """Fill utt2dur (seconds) — plain wav paths read only the RIFF header
    (utils/data/get_utt2dur.sh role); pipes must be decoded to count
    samples."""
    import wave

    from pkr_tpu_torch.io.wav import read_wav

    utt2dur = {}
    for utt, rx in dd.get("wav.scp").items():
        rx = rx.strip()
        if not rx.endswith("|") and os.path.exists(rx):
            try:
                with wave.open(rx, "rb") as w:
                    nf, fr = w.getnframes(), w.getframerate()
                # streaming writers leave 0/0xFFFFFFFF placeholder sizes:
                # only trust plausible headers, else count real samples
                if 0 < nf < 0x7FFFFFFF and fr > 0:
                    utt2dur[utt] = f"{nf / fr:.3f}"
                    continue
            except (wave.Error, EOFError, OSError):
                pass  # non-RIFF container: fall through to full decode
        wav, rate = read_wav(rx)
        utt2dur[utt] = f"{len(wav) / rate:.3f}"
    new = dict(dd.tables)
    new["utt2dur"] = utt2dur
    return DataDir(new)
