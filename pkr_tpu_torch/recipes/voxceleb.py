"""Corpus manifest builders (VoxCeleb1/2, MUSAN, trials).

A copy of ``pkr_tpu/recipes/voxceleb.py`` for the port (host code only).

Python ports of the Perl/py prep tools (SURVEY §2.5):
- local/make_voxceleb1_v2.pl — walk <root>/<dev|test>/wav/<spk>/<rec>/<n>.wav,
  utt id "spk-rec-name";
- local/make_voxceleb2.pl — walk <root>/<dev|test>/aac/.../<n>.m4a, wav.scp
  entries are ffmpeg decode pipes;
- local/make_voxceleb1_trials.pl — "1|0 path1 path2" lines →
  "utt1 utt2 target|nontarget";
- local/make_musan.py — music/speech/noise subtrees → data dirs (skipping
  music with vocals per the annotations);
- scripts/make_trials.py — rude / balance / part trial synthesis.
"""

from __future__ import annotations

import os
import shlex
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pkr_tpu_torch.io.datadir import DataDir


def _walk_utts(root: str, ext: str) -> List[Tuple[str, str, str]]:
    """[(spk, utt_id, file_path)] for <root>/<spk>/<rec>/<name>.<ext>."""
    out = []
    for spk in sorted(os.listdir(root)):
        spk_dir = os.path.join(root, spk)
        if not os.path.isdir(spk_dir):
            continue
        for rec in sorted(os.listdir(spk_dir)):
            rec_dir = os.path.join(spk_dir, rec)
            if not os.path.isdir(rec_dir):
                continue
            for f in sorted(os.listdir(rec_dir)):
                if f.endswith("." + ext):
                    name = f[: -(len(ext) + 1)]
                    out.append((spk, f"{spk}-{rec}-{name}", os.path.join(rec_dir, f)))
    return out


def make_voxceleb1(root: str, dataset: str = "dev") -> DataDir:
    """VoxCeleb1 (current directory layout) → DataDir."""
    assert dataset in ("dev", "test")
    wav_root = os.path.join(root, dataset, "wav")
    utt2spk, wav = {}, {}
    for spk, utt, path in _walk_utts(wav_root, "wav"):
        utt2spk[utt] = spk
        wav[utt] = path
    return DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()


def make_voxceleb2(root: str, dataset: str = "dev",
                   ffmpeg: str = "ffmpeg") -> DataDir:
    """VoxCeleb2 (m4a) → DataDir with ffmpeg decode pipes in wav.scp."""
    assert dataset in ("dev", "test")
    aac_root = os.path.join(root, dataset, "aac")
    utt2spk, wav = {}, {}
    for spk, utt, path in _walk_utts(aac_root, "m4a"):
        utt2spk[utt] = spk
        wav[utt] = (f"{ffmpeg} -v 8 -i {shlex.quote(path)} "
                            f"-f wav -acodec pcm_s16le -|")
    return DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()


def path_to_utt(path: str) -> str:
    """'Spk/rec/00001.wav' → 'Spk-rec-00001' (trials.pl path munging)."""
    parts = path.replace("\\", "/").split("/")
    name = parts[-1]
    if "." in name:
        name = name[: name.rindex(".")]
    return "-".join(parts[-3:-1] + [name])


def convert_voxceleb1_trials(src_path: str, out_path: str) -> int:
    """'1|0 <path1> <path2>' lines → '<utt1> <utt2> target|nontarget'
    (local/make_voxceleb1_trials.pl:25-46)."""
    n = 0
    with open(out_path, "w") as out:
        for line in open(src_path):
            parts = line.split()
            if len(parts) != 3:
                continue
            tgt = "target" if parts[0] == "1" else "nontarget"
            out.write(f"{path_to_utt(parts[1])} {path_to_utt(parts[2])} {tgt}\n")
            n += 1
    return n


def prepare_voxceleb1_trials(test_dir: str,
                             clean: str = None,
                             extended: str = None,
                             hard: str = None) -> Dict[str, int]:
    """The whole feature_pre.sh:61-73 stage-0 block as one step: convert the
    published VoxCeleb1 pair lists into trials_o / trials_e / trials_h inside
    `test_dir`, build the union wavlist of every utterance any list names,
    filter the data dir down to that wavlist (utt2spk backed up as
    utt2spk.bak like the reference), and fix it.  `test_dir` should be the
    COMBINED VoxCeleb1 dev+test dir (the reference's data/voxceleb1 copy) —
    trials_e/h reference dev-side utterances too.

    Returns {'trials_o': n, 'trials_e': n, 'trials_h': n, 'kept_utts': n}
    for whichever lists were given (at least one is required).
    """
    sources = {"trials_o": clean, "trials_e": extended, "trials_h": hard}
    if not any(sources.values()):
        raise ValueError("need at least one of clean/extended/hard")
    counts: Dict[str, int] = {}
    wavlist = set()
    for name, src in sources.items():
        if src is None:
            continue
        out_path = os.path.join(test_dir, name)
        counts[name] = convert_voxceleb1_trials(src, out_path)
        for line in open(out_path):
            a, b, _ = line.split()
            wavlist.add(a)
            wavlist.add(b)
    with open(os.path.join(test_dir, "wavlist"), "w") as f:
        f.write("".join(f"{u}\n" for u in sorted(wavlist)))
    dd = DataDir.load(test_dir)
    if "utt2spk" not in dd:
        raise ValueError(
            f"{test_dir} has no utt2spk — not a prepared data dir "
            "(if utt2spk.bak exists, a previous prep crashed mid-save; "
            "restore the backup and re-run)")
    bak = os.path.join(test_dir, "utt2spk.bak")
    if not os.path.exists(bak):
        # first run only: the backup is the PRE-filter map — a re-run must
        # not clobber it with the already-filtered table (the dir itself is
        # filtered in place, so a broader trial list needs a re-prepared dir
        # either way; the missing-utterance warning below flags that case).
        # COPY rather than move: a failure between here and dd.save() must
        # leave the dir loadable, not brick it with a missing utt2spk
        import shutil

        shutil.copyfile(os.path.join(test_dir, "utt2spk"), bak)
    dd = dd.filter_utts(wavlist).fix()
    missing = wavlist - set(dd["utt2spk"])
    if missing:
        # trial utterances absent from the prepared dir (e.g. a partial
        # corpus download) would make every scorer raise on a missing key —
        # surface it here, at prep time
        print(f"WARNING: {len(missing)} trial utterances are not in "
              f"{test_dir} (e.g. {sorted(missing)[0]})")
    dd.save(test_dir)
    counts["kept_utts"] = dd.num_utts
    return counts


def make_musan(root: str, use_vocals: bool = False) -> Dict[str, DataDir]:
    """MUSAN tree → {'music': DataDir, 'speech': ..., 'noise': ...}
    (local/make_musan.py semantics incl. vocal-music filtering)."""
    out = {}
    for kind in ("music", "speech", "noise"):
        kdir = os.path.join(root, kind)
        if not os.path.isdir(kdir):
            continue
        utt2spk, wav = {}, {}
        for sub in sorted(os.listdir(kdir)):
            subdir = os.path.join(kdir, sub)
            if not os.path.isdir(subdir):
                continue
            vocals = set()
            ann = os.path.join(subdir, "ANNOTATIONS")
            if kind == "music" and not use_vocals and os.path.exists(ann):
                for line in open(ann):
                    parts = line.split()
                    if len(parts) >= 3 and parts[2].strip() in ("Y", "y"):
                        vocals.add(parts[0])
            for f in sorted(os.listdir(subdir)):
                if not f.endswith(".wav"):
                    continue
                utt = f[:-4]
                if utt in vocals:
                    continue
                utt2spk[utt] = utt  # musan "speakers" are the utts themselves
                wav[utt] = os.path.join(subdir, f)
        out[kind] = DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()
    return out


def make_trials(enroll: DataDir, test: DataDir, strategy: str = "rude",
                music: Optional[DataDir] = None, seed: int = 0
                ) -> List[Tuple[str, str, str]]:
    """Trial synthesis strategies (scripts/make_trials.py:27-57):
    'rude' = full enroll×test cross; 'balance' = each target trial paired with
    one random impostor draw; 'part' = targets plus music impostors."""
    rng = np.random.default_rng(seed)
    enroll_spks = enroll.spks
    test_u2s = test["utt2spk"]
    trials: List[Tuple[str, str, str]] = []
    if strategy == "rude":
        for utt, spk in test_u2s.items():
            for espk in enroll_spks:
                trials.append((espk, utt, "target" if spk == espk else "nontarget"))
    elif strategy == "balance":
        keys = list(test_u2s)
        for utt, spk in test_u2s.items():
            if spk in enroll_spks:
                trials.append((spk, utt, "target"))
                other = keys[rng.integers(0, len(keys))]
                t = "target" if test_u2s[other] == spk else "nontarget"
                trials.append((spk, other, t))
    elif strategy == "part":
        assert music is not None, "'part' needs a music data dir"
        music_utts = list(music["utt2spk"])
        for utt, spk in test_u2s.items():
            if spk in enroll_spks:
                trials.append((spk, utt, "target"))
                for _ in range(len(enroll_spks)):
                    trials.append((spk, music_utts[rng.integers(0, len(music_utts))],
                                   "nontarget"))
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return trials


def write_trials(path: str, trials: Sequence[Tuple[str, str, str]]) -> None:
    with open(path, "w") as f:
        for a, b, t in trials:
            f.write(f"{a} {b} {t}\n")


def make_voxceleb1_old_layout(root: str, trials_txt: Optional[str] = None
                              ) -> Tuple[DataDir, DataDir, List[Tuple[str, str, str]]]:
    """The ORIGINAL VoxCeleb1 directory layout (local/make_voxceleb1.pl):
    <root>/voxceleb1_wav/<spk>/<rec11chars>_<seg7chars>.wav, with the trial
    file deciding which speakers form the test split.

    Returns (train_dir, test_dir, trials) where trials entries use the
    'spk-rec-seg' utt ids.
    """
    trials_txt = trials_txt or os.path.join(root, "voxceleb1_test.txt")
    test_spks = set()
    trials: List[Tuple[str, str, str]] = []

    def path_to_id(path: str) -> Tuple[str, str]:
        spk, filename = path.split("/", 1)
        name = filename[: filename.rindex(".")] if "." in filename else filename
        rec, seg = name[:11], name[12:19]
        return spk, f"{spk}-{rec}-{seg}"

    if os.path.exists(trials_txt):
        for line in open(trials_txt):
            parts = line.split()
            if len(parts) != 3:
                continue
            s1, u1 = path_to_id(parts[1])
            s2, u2 = path_to_id(parts[2])
            test_spks.update((s1, s2))
            trials.append((u1, u2, "target" if parts[0] == "1" else "nontarget"))

    wav_root = os.path.join(root, "voxceleb1_wav")
    train_u2s, train_wav, test_u2s, test_wav = {}, {}, {}, {}
    for spk in sorted(os.listdir(wav_root)):
        spk_dir = os.path.join(wav_root, spk)
        if not os.path.isdir(spk_dir):
            continue
        for f in sorted(os.listdir(spk_dir)):
            if not f.endswith(".wav"):
                continue
            name = f[:-4]
            utt = f"{spk}-{name[:11]}-{name[12:19]}"
            path = os.path.join(spk_dir, f)
            if spk in test_spks:
                test_u2s[utt] = spk
                test_wav[utt] = path
            else:
                train_u2s[utt] = spk
                train_wav[utt] = path
    train = DataDir({"utt2spk": train_u2s, "wav.scp": train_wav}).make_spk2utt()
    test = DataDir({"utt2spk": test_u2s, "wav.scp": test_wav}).make_spk2utt()
    return train, test, trials


def make_vctk(root: str, resample_cmd: str = "ffmpeg",
              rate: int = 16000) -> DataDir:
    """VCTK corpus → DataDir (local/make_vctk.pl + make_vctk_wav.py role):
    <root>/wav48/<spk>/<spk>_<utt>.wav entries with a mono/16 kHz resample
    pipe in wav.scp (the reference used sox; ffmpeg ships more often)."""
    wav_root = os.path.join(root, "wav48")
    if not os.path.isdir(wav_root):
        wav_root = os.path.join(root, "wav")
    utt2spk, wav = {}, {}
    for spk in sorted(os.listdir(wav_root)):
        spk_dir = os.path.join(wav_root, spk)
        if not os.path.isdir(spk_dir):
            continue
        for f in sorted(os.listdir(spk_dir)):
            if not f.endswith(".wav"):
                continue
            utt = f[:-4]
            path = os.path.join(spk_dir, f)
            q = shlex.quote(path)
            if resample_cmd == "sox":
                cmd = f"sox {q} -t wav -r {rate} -c 1 - |"
            else:
                cmd = (f"ffmpeg -v 8 -i {q} -f wav -ar {rate} -ac 1 "
                       f"-acodec pcm_s16le -|")
            utt2spk[utt] = spk
            wav[utt] = cmd
    return DataDir({"utt2spk": utt2spk, "wav.scp": wav}).make_spk2utt()
