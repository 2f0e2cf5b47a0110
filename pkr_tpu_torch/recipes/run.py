"""Stage-gated recipe driver of the port, on one card.

Port of ``pkr_tpu/recipes/run.py``: the Python CLI that replaces the
reference's bash recipe stack (run.sh / run_aam_v2.sh / feature_pre.sh /
test.sh): one process, numbered stages, a single typed Config, resumable at
any stage via --stage / --stop-stage, artifacts laid out Kaldi-style under
--exp-dir (feats.scp/ark, vad.scp, utt2spkid, text embedding arks, score
files, eer/minDCF files).

Stages:
  0  validate the data dirs (wav.scp/utt2spk under --data-dir, e.g. from
     pkr_tpu_torch.recipes.voxceleb builders)
  1  features: wav → fbank (+VAD +sliding CMVN +voiced-selection) on the
     card → compressed ark/scp      [feature_pre.sh stages 1+4]
  2  filter ≥min-frames, train/cv split, utt2spkid, num_spk
                                      [feature_pre.sh stage 5]
  3  train                            [run_aam_v2.sh stages 7-8]
  4  extract embeddings               [run_aam_v2.sh stage 9 / decode.py]
  5  backend stats: global mean, speaker means, cohort top-k
                                      [run_aam_v2.sh stages 10-11]
  6  score + EER/minDCF               [test.sh]

``--device`` (default: the card) is where the stages' tensors live; without
a card and without ``--device cpu``, ``main`` raises.  One process on one
card: augmentation pools (``--musan-dir``, ``--rir-dir``, ``utt2aug``
mixing; ROADMAP.md A.5) and the class-sharded head
(``train.model_parallel > 1``; A.11) raise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device


def _stage_range(args):
    return range(args.stage, args.stop_stage + 1)


class _ShardedFeatWriter:
    """N encoder workers, each owning its own feats/vad ark+scp pair — the
    reference's per-nj `raw_fbank_$name.JOB.{ark,scp}` layout
    (local/make_fbank.sh:118-126) realized as threads inside the one device
    process (the nj fan-out moves to the host-side CM encode, which is
    numpy-vectorized and releases the GIL).  Utterances are assigned
    round-robin in drain order; close() concatenates the shard scps into
    feats.scp / vad.scp."""

    def __init__(self, out_dir: str, n_workers: int):
        import queue
        import threading

        from pkr_tpu_torch.io import write_ark_scp

        self.out_dir = out_dir
        self.n = n_workers
        self._queues = [queue.Queue(maxsize=128) for _ in range(n_workers)]
        self._writers = [
            (write_ark_scp(os.path.join(out_dir, f"feats.{i}.ark"),
                           os.path.join(out_dir, f"feats.{i}.scp"),
                           compress=True),
             write_ark_scp(os.path.join(out_dir, f"vad.{i}.ark"),
                           os.path.join(out_dir, f"vad.{i}.scp")))
            for i in range(n_workers)]
        self._errors: List[BaseException] = []
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True)
            for i in range(n_workers)]
        for t in self._threads:
            t.start()
        self._next = 0

    def _run(self, i: int) -> None:
        fw, vw = self._writers[i]
        while True:
            item = self._queues[i].get()
            if item is None:
                return
            try:
                utt, feat, vad = item
                fw.write(utt, feat)
                vw.write(utt, vad)
            except BaseException as e:  # surfaced by close()
                self._errors.append(e)
                return

    def write(self, utt: str, feat, vad) -> None:
        import queue

        # bounded put + error re-check: a dead worker's queue stays full, so
        # a plain put() would deadlock the whole stage behind it
        while True:
            if self._errors:
                raise self._errors[0]
            try:
                self._queues[self._next].put((utt, feat, vad), timeout=5.0)
                break
            except queue.Full:
                continue
        self._next = (self._next + 1) % self.n

    def close(self) -> None:
        import queue

        # bounded sentinel delivery: a worker that died on error leaves its
        # queue full — only keep trying while the thread is actually alive,
        # else close() would hang exactly like the write() case
        for q, t in zip(self._queues, self._threads):
            while t.is_alive():
                try:
                    q.put(None, timeout=2.0)
                    break
                except queue.Full:
                    continue
        for t in self._threads:
            t.join(timeout=600.0)
        # a join that timed out leaves a worker mid-write: closing/merging
        # under it would emit a truncated ark that LOOKS complete — fail
        # loudly instead
        stuck = sum(t.is_alive() for t in self._threads)
        if stuck:
            raise RuntimeError(
                f"{stuck} encode worker(s) still running after 600s join — "
                "refusing to merge possibly-truncated shard arks")
        for fw, vw in self._writers:
            fw.close()
            vw.close()
        if self._errors:
            raise self._errors[0]
        for name in ("feats", "vad"):
            with open(os.path.join(self.out_dir, f"{name}.scp"), "w") as out:
                for i in range(self.n):
                    shard = os.path.join(self.out_dir, f"{name}.{i}.scp")
                    out.write(open(shard).read())
                    os.remove(shard)

    def abort(self) -> None:
        """Best-effort shutdown for the error path: wake workers, join
        briefly, close file handles — no scp merge, no error re-raise (the
        caller already has its own exception in flight)."""
        import queue

        for q, t in zip(self._queues, self._threads):
            if t.is_alive():
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass
        for t in self._threads:
            t.join(timeout=5.0)
        for fw, vw in self._writers:
            try:
                fw.close()
                vw.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not exc[0]:
            self.close()
        else:
            self.abort()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a copy of ``t`` to host memory: from the card into pinned
    memory without waiting (read it after the bucket's event)."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def run_features(data_dir: str, out_dir: str, batch: int = 32,
                 quantum_sec: float = 2.0, dither: float = 1.0,
                 apply_vad: bool = True, seed: int = 0,
                 pools=None, n_jobs: int = 4, frontend=None,
                 encode_workers: int = 1, device: DeviceLike = None) -> None:
    """Batched feature extraction on the card over a data dir's wav.scp.

    `frontend` (a pkr_tpu_torch.frontend.FrontendConfig) carries the FULL
    feature configuration — mel bins, freq range, VAD thresholds, CMVN
    window … (conf/fbank.conf + conf/vad.conf roles); without it, defaults
    with the given `dither` apply.  utt2speed entries are resampled at
    decode and utt2warp entries set the bucket's VTLN warp; mixing utt2aug
    copies needs augmentation pools, which the port does not have yet
    (`pools` raises; without it utt2aug copies get clean features, with a
    warning).  Wav decode runs on an n_jobs thread pool (the nj-way fan-out
    of make_fbank.sh's run.pl jobs); the dither draws come from one
    ``torch.Generator`` on the device seeded by `seed`.

    Buckets run through a one-deep pipeline: the card computes bucket k
    while the host CM-encodes bucket k−1 (its results are copied back into
    pinned memory behind bucket k's work)."""
    import contextlib
    import dataclasses

    from pkr_tpu_torch.frontend import FrontendConfig, wav_to_train_feats
    from pkr_tpu_torch.frontend.features import FbankConfig, num_frames
    from pkr_tpu_torch.io import DataDir, write_ark_scp
    from pkr_tpu_torch.io.wav import read_wav

    if pools is not None:
        raise NotImplementedError(
            "augmentation pools are not ported yet (ROADMAP.md A.5)")
    dev = resolve_device(device)
    dd = DataDir.load(data_dir)
    utt2aug = dd.get("utt2aug")
    if any(k != "none" for k in utt2aug.values()):
        print(f"WARNING: {data_dir} has utt2aug entries but no augmentation "
              "pools were given — the augmented-named copies will get CLEAN "
              "features (exact duplicates of their source utterances)")
    utt2speed = dd.get("utt2speed")
    utt2warp = dd.get("utt2warp")  # per-utterance VTLN (make_fbank.sh:74-80)
    if frontend is not None:
        cfg = dataclasses.replace(
            frontend, fbank=dataclasses.replace(frontend.fbank, dither=dither))
    else:
        cfg = FrontendConfig(fbank=FbankConfig(dither=dither))
    fb = cfg.fbank
    cfg_by_warp = {}

    def cfg_for(warp: float):
        if warp not in cfg_by_warp:
            cfg_by_warp[warp] = (cfg if warp == 1.0 else dataclasses.replace(
                cfg, fbank=dataclasses.replace(fb, vtln_warp=warp)))
        return cfg_by_warp[warp]

    gen = torch.Generator(device=dev).manual_seed(seed)
    os.makedirs(out_dir, exist_ok=True)

    # group utterances into duration buckets for static shapes
    entries = sorted(dd["wav.scp"].items())
    quantum = int(quantum_sec * fb.sample_frequency)

    buckets: Dict[Tuple[int, float], List[Tuple[str, np.ndarray]]] = {}
    utt2nf = {}
    with contextlib.ExitStack() as stack:
        if encode_workers > 1:
            sink = stack.enter_context(
                _ShardedFeatWriter(out_dir, encode_workers))
            emit = sink.write
        else:
            fw = stack.enter_context(
                write_ark_scp(os.path.join(out_dir, "feats.ark"),
                              os.path.join(out_dir, "feats.scp"),
                              compress=True))
            vw = stack.enter_context(
                write_ark_scp(os.path.join(out_dir, "vad.ark"),
                              os.path.join(out_dir, "vad.scp")))

            def emit(utt, feat, vad):
                fw.write(utt, feat)
                vw.write(utt, vad)

        def flush(bucket_key, items):
            L, warp = bucket_key
            B = len(items)
            # pad tail buckets to the full batch (zero rows, length 0,
            # dropped at write-out): one shape per (L, warp)
            Bp = batch if B < batch else B
            wavs = np.zeros((Bp, L), np.float32)
            lens = np.zeros((Bp,), np.int64)
            for b, (utt, w) in enumerate(items):
                wavs[b, : len(w)] = w
                lens[b] = len(w)
            feats, mask, vad = wav_to_train_feats(
                wavs, lens, gen, cfg_for(warp), apply_vad=apply_vad, device=dev)
            # pipeline: queue this bucket's copy back, then write out the
            # PREVIOUS bucket while the card works on this one
            host = tuple(_to_host(t) for t in (feats, mask, vad))
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            pending.append((items, lens[:B], host, done))
            if len(pending) > 1:
                drain_one()

        def drain_one():
            items, lens, host, done = pending.pop(0)
            if done is not None:
                done.synchronize()
            feats, mask, vad = (t.numpy() for t in host)
            for b, (utt, w) in enumerate(items):
                n = int(mask[b].sum())
                nf = int(num_frames(int(lens[b]), fb))
                emit(utt, feats[b, :n], vad[b, :nf].astype(np.float32))
                utt2nf[utt] = n

        pending: List[tuple] = []

        def decode(entry):
            utt, rx = entry
            wav, rate = read_wav(rx)
            if rate != fb.sample_frequency:
                raise ValueError(f"{utt}: {rate} Hz, the frontend expects "
                                 f"{fb.sample_frequency}")
            speed = float(utt2speed.get(utt, "1.0")) if utt2speed else 1.0
            if speed != 1.0:
                from pkr_tpu_torch.data.augment import speed_perturb

                wav = speed_perturb(wav, speed)
            return utt, wav

        if n_jobs > 1 and len(entries) > 1:
            from multiprocessing.pool import ThreadPool

            pool = stack.enter_context(ThreadPool(n_jobs))
            decoded = pool.imap(decode, entries)  # ordered: determinism
        else:
            decoded = map(decode, entries)

        for utt, wav in decoded:
            L = int(np.ceil(max(len(wav), quantum) / quantum) * quantum)
            warp = float(utt2warp.get(utt, "1.0")) if utt2warp else 1.0
            bkey = (L, warp)
            buckets.setdefault(bkey, []).append((utt, wav))
            if len(buckets[bkey]) == batch:
                flush(bkey, buckets.pop(bkey))
        for bkey in sorted(buckets):
            flush(bkey, buckets[bkey])
        while pending:
            drain_one()

    with open(os.path.join(out_dir, "utt2num_frames"), "w") as f:
        for utt in sorted(utt2nf):
            f.write(f"{utt} {utt2nf[utt]}\n")


def run_split(feat_dir: str, data_dir: str, min_frames: int,
              cv_fraction: float, seed: int) -> int:
    from pkr_tpu_torch.io import DataDir

    dd = DataDir.load(data_dir, names=("utt2spk",))
    for name in ("feats.scp", "vad.scp", "utt2num_frames"):
        fd = DataDir.load(feat_dir, names=(name,))
        if name in fd:
            dd.tables[name] = fd[name]
    dd = dd.fix().filter_min_frames(min_frames)
    if dd.num_utts == 0:
        raise RuntimeError(
            f"no utterances survived the >={min_frames}-frame filter in "
            f"{feat_dir} — lower data.min_frames or use longer audio")
    dd, num_spk = dd.assign_spk_ids()
    train, cv = dd.train_cv_split(cv_fraction, seed)
    train.save(os.path.join(feat_dir, "train"))
    cv.save(os.path.join(feat_dir, "cv"))
    with open(os.path.join(feat_dir, "num_spk"), "w") as f:
        f.write(str(num_spk))
    return num_spk


def build_model(cfg_model, num_spk: int, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16,
                generator: Optional[torch.Generator] = None):
    """The port's SpeakerModel for a ModelConfig, with a bf16 trunk (the
    reference's default compute type); weights drawn from `generator` (a CPU
    ``torch.Generator``) when one is given."""
    from pkr_tpu_torch.models import SpeakerModel

    return SpeakerModel(spk_num=num_spk, feat_dim=cfg_model.feat_dim,
                        pooling=cfg_model.pooling, loss=cfg_model.loss,
                        m=cfg_model.margin, s=cfg_model.scale,
                        trunk=cfg_model.trunk, emb_dim=cfg_model.emb_dim,
                        dtype=dtype, device=device, generator=generator)


def run_train(cfg, feat_dir: str, exp_dir: str, device: DeviceLike = None) -> None:
    from pkr_tpu_torch.data import (BalancedRepetitionSampler, FeatureSource,
                                    SpeakerBalancedSampler, TrainLoader)
    from pkr_tpu_torch.train import create_train_state, train_and_validate
    from pkr_tpu_torch.train.checkpoint import (import_torch_checkpoint,
                                                load_pretrained,
                                                restore_checkpoint,
                                                save_checkpoint,
                                                wait_for_checkpoints)
    from pkr_tpu_torch.utils.logging import ProgressLogger

    if cfg.train.model_parallel > 1:
        raise ValueError("train.model_parallel > 1 needs the class-sharded head, "
                         "which the port does not have yet (ROADMAP.md A.11)")
    dev = resolve_device(device)
    os.makedirs(exp_dir, exist_ok=True)
    num_spk = int(open(os.path.join(feat_dir, "num_spk")).read())
    model = build_model(cfg.model, num_spk, dev,
                        generator=torch.Generator().manual_seed(cfg.train.seed))

    def make_loader(split):
        scp = os.path.join(feat_dir, split, "feats.scp")
        src = FeatureSource(scp)
        u2id = {u: int(v) for u, v in
                (l.split() for l in open(os.path.join(feat_dir, split, "utt2spkid")))}
        labels = [u2id[u] for u in src.utts]
        sampler_cls = (SpeakerBalancedSampler if cfg.train.dataset == "v2"
                       else BalancedRepetitionSampler)
        sampler = sampler_cls(src.utts, labels)
        chunk = (cfg.train.chunk_size[0] if len(cfg.train.chunk_size) == 1
                 else tuple(cfg.train.chunk_size))
        # a cv split smaller than the batch would silently validate nothing;
        # on one process the batch never exceeds the split, so the
        # reference's tiling of a too-small split (_TileToBatch, for a
        # mesh-divisible batch) never applies
        batch = max(1, min(cfg.train.batch_size, len(sampler)))
        if cfg.train.device_cache and split == "train" and isinstance(chunk, int):
            from pkr_tpu_torch.data import DeviceCacheLoader, DeviceFeatureCache

            cache = DeviceFeatureCache.from_scp(scp, u2id, device=dev)
            print(f"device cache: {cache.nbytes / 1e6:.1f} MB in device memory "
                  f"({len(src)} utterances)")
            return DeviceCacheLoader(cache, sampler, batch, chunk,
                                     seed=cfg.train.seed, device=dev)
        return TrainLoader(src, labels, sampler, batch, chunk, seed=cfg.train.seed)

    train_loader, cv_loader = make_loader("train"), make_loader("cv")
    state = create_train_state(model)
    start_epoch = 0
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if cfg.train.resume:
        restored = restore_checkpoint(ckpt_dir, model, state)
        if restored is not None:
            state = restored
            start_epoch = state.epoch
    elif cfg.train.pretrained:
        if cfg.train.pretrained.endswith((".pth", ".pth.tar", ".pt")):
            sd = torch.load(cfg.train.pretrained, map_location="cpu")
            import_torch_checkpoint(sd.get("state_dict", sd), model)
        else:
            load_pretrained(cfg.train.pretrained, model)

    logger = ProgressLogger(jsonl_path=os.path.join(exp_dir, "train_metrics.jsonl"))

    def on_epoch_end(state, epoch, metrics):
        save_checkpoint(ckpt_dir, model, state, is_best=metrics["is_best"],
                        keep_last=cfg.train.keep_last_checkpoints)

    try:
        train_and_validate(model, state, train_loader, cv_loader,
                           epochs=cfg.train.epochs, lr0=cfg.train.lr,
                           lr_final=cfg.train.lr_final, momentum=cfg.train.momentum,
                           weight_decay=cfg.train.weight_decay,
                           start_epoch=start_epoch, print_freq=cfg.train.print_freq,
                           on_epoch_end=on_epoch_end, logger=logger,
                           flash_aam=cfg.train.flash_aam,
                           save_every_steps=cfg.train.save_every_steps,
                           on_step_save=(lambda st: save_checkpoint(
                               ckpt_dir, model, st,
                               keep_last=cfg.train.keep_last_checkpoints))
                           if cfg.train.save_every_steps else None,
                           profile_dir=cfg.train.profile_dir,
                           profile_steps=cfg.train.profile_steps, device=dev)
        wait_for_checkpoints()  # the last save is async; commit before returning
    finally:
        logger.close()


def select_decode_subset(scp: str, n: int, seed: int, out_path: str) -> str:
    """feature_pre.sh:244-246 (`shuf | head -N`): a seeded random N-utterance
    subset of a feats.scp, written as a derived scp.  Used for the backend
    cohort extraction so mean/LDA/PLDA/S-norm stats don't require a full
    multi-million-utterance forward pass."""
    lines = open(scp).read().splitlines()
    if n <= 0 or n >= len(lines):
        # no-op subset: still (re)write out_path with the FULL list so the
        # file's content always reflects THIS run's decision
        keep = range(len(lines))
    else:
        rng = np.random.default_rng(seed)
        keep = sorted(rng.choice(len(lines), n, replace=False))
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        # per-line writes: an empty keep list yields an empty file, not a
        # single blank line that downstream scp parsing would reject
        f.write("".join(f"{lines[i]}\n" for i in keep))
    os.replace(tmp, out_path)
    return out_path


def run_extract(cfg, feat_dir: str, exp_dir: str, scp: str, out_name: str,
                subset: int = 0, device: DeviceLike = None) -> None:
    from pkr_tpu_torch.data import EvalLoader, FeatureSource
    from pkr_tpu_torch.eval.extract import extract_embeddings
    from pkr_tpu_torch.io import write_text_vec_ark
    from pkr_tpu_torch.train.checkpoint import restore_checkpoint

    dev = resolve_device(device)
    num_spk = int(open(os.path.join(feat_dir, "num_spk")).read())
    model = build_model(cfg.model, num_spk, dev)
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    restored = restore_checkpoint(ckpt_dir, model, which="best")
    if restored is None:
        restored = restore_checkpoint(ckpt_dir, model)
    if restored is None:
        raise RuntimeError(f"no checkpoint to extract from in {ckpt_dir}")
    if subset:
        scp = select_decode_subset(scp, subset, cfg.train.seed,
                                   os.path.join(exp_dir, f"decode_{out_name}.scp"))
    loader = EvalLoader(FeatureSource(scp), batch_size=cfg.eval.batch_size,
                        quantum=cfg.eval.bucket_quantum, max_len=cfg.eval.max_len,
                        chunk_size=cfg.eval.chunk_size,
                        long_mode=cfg.eval.long_mode,
                        transport=cfg.eval.transport)
    embs = extract_embeddings(model, loader, device=dev)
    write_text_vec_ark(os.path.join(exp_dir, out_name), embs)


def run_score(cfg, exp_dir: str, trials_path: str, enroll_ark: str,
              test_ark: str, cohort_ark: Optional[str] = None,
              cohort_utt2spk: Optional[Dict[str, str]] = None,
              enroll_spk2utt: Optional[Dict[str, List[str]]] = None,
              device: DeviceLike = None) -> Dict[str, float]:
    """Backends (test.sh / test2.sh parity): 'cosine', 'snorm' (adaptive
    S-norm over cohort top-k stats), 'plda' (LDA→length-norm→PLDA LLR,
    run.sh:323-351), 'pool' (spk2utt-pooled enrollment means, test2.sh:72-93)."""
    from pkr_tpu_torch.eval.metrics import compute_eer, compute_min_dcf
    from pkr_tpu_torch.eval.scoring import (adaptive_snorm, cohort_topk_stats,
                                            cosine_scores, global_mean,
                                            pooled_speaker_means, read_trials,
                                            speaker_means, write_scores)
    from pkr_tpu_torch.io import load_text_vec_ark

    dev = resolve_device(device)
    enroll = load_text_vec_ark(enroll_ark)
    test = load_text_vec_ark(test_ark)
    pairs, labels = read_trials(trials_path)
    mean = None
    cohort_vecs = None
    if cohort_ark:
        cohort_vecs = load_text_vec_ark(cohort_ark)
        mean = global_mean(cohort_vecs)

    backend = cfg.eval.backend
    if backend == "pool":
        if not enroll_spk2utt:
            raise ValueError("'pool' backend needs an enroll spk2utt")
        enroll = pooled_speaker_means(enroll, enroll_spk2utt)
        backend = "cosine"

    if backend == "plda":
        from pkr_tpu_torch.eval.plda import (compute_lda, length_normalize,
                                             plda_scores, train_plda)

        if not (cohort_vecs and cohort_utt2spk):
            raise ValueError("plda needs a cohort ark and its utt2spk")
        # run.sh:332 pins --total-covariance-factor=0.0 (pure within-class
        # whitening), not ivector-compute-lda's 0.1 default
        lda = compute_lda(cohort_vecs, cohort_utt2spk, dim=min(
            cfg.eval.lda_dim, len(next(iter(cohort_vecs.values())))),
            total_covariance_factor=0.0)

        def prep(vs):
            # lda.apply already centers on the cohort mean (the
            # ivector-subtract-global-mean step, run.sh:332-340) — passing
            # v - mean here would subtract it twice
            return {k: length_normalize(lda.apply(v)) for k, v in vs.items()}

        model = train_plda(prep(cohort_vecs), cohort_utt2spk)
        scores = plda_scores(model, prep(enroll), prep(test), pairs)
    else:
        scores = cosine_scores(enroll, test, pairs, mean, device=dev)
        if backend == "snorm":
            if cohort_vecs is None:
                raise ValueError("snorm needs a cohort ark")
            # the reference's cohort is PER-SPEAKER means of the training
            # embeddings (compute_mean_byspk → compute_topk_mean_std,
            # run_aam_v2.sh:139-174), not raw utterance vectors
            if cohort_utt2spk:
                cohort = np.stack(list(
                    speaker_means(cohort_vecs, cohort_utt2spk).values()))
            else:
                cohort = np.stack(list(cohort_vecs.values()))
            e_stats = cohort_topk_stats(enroll, cohort, cfg.eval.topk, mean, device=dev)
            t_stats = cohort_topk_stats(test, cohort, cfg.eval.topk, mean, device=dev)
            scores = adaptive_snorm(scores, pairs, e_stats, t_stats)
    write_scores(os.path.join(exp_dir, "scores.txt"), pairs, scores)
    if not labels:  # pairs-only trial list: scores written, no metrics
        results = {"n_trials": len(pairs)}
    else:
        results = {"eer": compute_eer(scores.tolist(), labels)}
        for p in cfg.eval.p_targets:
            results[f"min_dcf_p{p}"], _ = compute_min_dcf(scores.tolist(), labels, p)
    with open(os.path.join(exp_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def run_backend_stats(cfg, exp_dir: str, data_dir: str,
                      device: DeviceLike = None) -> None:
    """Write the backend artifacts the reference recipes materialize
    (run_aam_v2.sh:139-174): mean.vec (binary Kaldi vector), per-speaker
    cohort means (text ark), and the cohort top-k mean/std table."""
    from pkr_tpu_torch.eval.scoring import (cohort_topk_stats, global_mean,
                                            speaker_means)
    from pkr_tpu_torch.io import (DataDir, load_text_vec_ark, write_text_vec_ark,
                                  write_vec_flt)

    dev = resolve_device(device)
    train = load_text_vec_ark(os.path.join(exp_dir, "train.iv"))
    mean = global_mean(train)
    write_vec_flt(os.path.join(exp_dir, "mean.vec"), mean.astype(np.float32))
    utt2spk = DataDir.load(data_dir, names=("utt2spk",)).get("utt2spk")
    if utt2spk:
        spk_means = speaker_means(train, utt2spk)
        write_text_vec_ark(os.path.join(exp_dir, "spk_xvector.iv"), spk_means)
        cohort = np.stack(list(spk_means.values()))
    else:
        cohort = np.stack(list(train.values()))
    test_path = os.path.join(exp_dir, "test.iv")
    if os.path.exists(test_path):
        test = load_text_vec_ark(test_path)
        stats = cohort_topk_stats(test, cohort, cfg.eval.topk, mean, device=dev)
        with open(os.path.join(exp_dir, "topk_mean_std"), "w") as f:
            for k, (mu, sd) in stats.items():
                f.write(f"{k} {mu} {sd}\n")


def main(argv=None):
    import dataclasses

    from pkr_tpu_torch.config import Config
    from pkr_tpu_torch.io import DataDir

    ap = argparse.ArgumentParser(description="pkr_tpu_torch recipe driver")
    ap.add_argument("--config", type=str, default=None, help="JSON config path")
    ap.add_argument("--preset", type=str, default=None,
                    help="named recipe preset (see pkr_tpu_torch.recipes.presets)")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--stop-stage", type=int, default=6)
    ap.add_argument("--data-dir", type=str, required=True,
                    help="dir with wav.scp/utt2spk (train corpus)")
    ap.add_argument("--test-data-dir", type=str, default=None)
    ap.add_argument("--trials", type=str, default=None)
    ap.add_argument("--exp-dir", type=str, default="exp/run")
    ap.add_argument("--backend", type=str, default=None,
                    help="override eval backend (cosine|snorm|plda|pool)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="capture a torch.profiler trace of ~10 steady-state "
                         "training steps into this dir (stage 3)")
    ap.add_argument("--musan-dir", type=str, default=None,
                    help="MUSAN root for utt2aug augmentation pools (not "
                         "ported yet)")
    ap.add_argument("--rir-dir", type=str, default=None,
                    help="RIRS_NOISES-style root for the utt2aug 'reverb' "
                         "branch (not ported yet)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of every stage (default: the card; "
                         "'cpu' runs the plain PyTorch versions on the CPU)")
    args = ap.parse_args(argv)

    if args.musan_dir or args.rir_dir:
        raise NotImplementedError("--musan-dir/--rir-dir need augmentation pools, "
                                  "which the port does not have yet (ROADMAP.md A.5)")
    dev = resolve_device(args.device)
    if args.preset:
        from pkr_tpu_torch.recipes.presets import PRESETS

        cfg = PRESETS[args.preset]()
    elif args.config:
        cfg = Config.from_json(open(args.config).read())
    else:
        cfg = Config()
    if args.backend:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, backend=args.backend))
    if args.profile_dir:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, profile_dir=args.profile_dir))
    os.makedirs(args.exp_dir, exist_ok=True)
    feat_dir = os.path.join(args.exp_dir, "feats")
    test_feat_dir = os.path.join(args.exp_dir, "feats_test")

    for stage in _stage_range(args):
        if stage == 0:
            for d in filter(None, (args.data_dir, args.test_data_dir)):
                dd = DataDir.load(d)
                problems = dd.validate()
                print(f"== stage 0: {d}: {dd.num_utts} utts / "
                      f"{len(dd.spks)} speakers"
                      + (f"  PROBLEMS: {problems}" if problems else "  OK"))
                if problems:
                    raise RuntimeError(f"data dir {d} failed validation: {problems}")
        elif stage == 1:
            print(f"== stage 1: features → {feat_dir}")
            dither = cfg.frontend.fbank.dither
            run_features(args.data_dir, feat_dir, dither=dither,
                         seed=cfg.train.seed, frontend=cfg.frontend,
                         n_jobs=cfg.data.decode_jobs,
                         encode_workers=cfg.data.encode_workers, device=dev)
            if args.test_data_dir:
                run_features(args.test_data_dir, test_feat_dir, dither=dither,
                             seed=cfg.train.seed, frontend=cfg.frontend,
                             n_jobs=cfg.data.decode_jobs,
                             encode_workers=cfg.data.encode_workers, device=dev)
        elif stage == 2:
            print("== stage 2: filter/split/labels")
            n = run_split(feat_dir, args.data_dir, cfg.data.min_frames,
                          cfg.data.cv_fraction, cfg.train.seed)
            print(f"num_spk={n}")
        elif stage == 3:
            print("== stage 3: train")
            run_train(cfg, feat_dir, args.exp_dir, device=dev)
        elif stage == 4:
            print("== stage 4: extract")
            # the train/cohort side honors eval.cohort_subset
            # (feature_pre.sh's 500k decode_train.scp); test stays full
            run_extract(cfg, feat_dir, args.exp_dir,
                        os.path.join(feat_dir, "train", "feats.scp"),
                        "train.iv", subset=cfg.eval.cohort_subset, device=dev)
            if args.test_data_dir:
                run_extract(cfg, feat_dir, args.exp_dir,
                            os.path.join(test_feat_dir, "feats.scp"), "test.iv",
                            device=dev)
        elif stage == 5:
            print("== stage 5: backend stats")
            run_backend_stats(cfg, args.exp_dir, args.data_dir, device=dev)
        elif stage == 6 and args.trials:
            print("== stage 6: score")
            cohort_u2s = DataDir.load(args.data_dir, names=("utt2spk",)).get("utt2spk")
            enroll_s2u = None
            if args.test_data_dir:
                tdd = DataDir.load(args.test_data_dir, names=("utt2spk",))
                enroll_s2u = {s: v.split() for s, v in
                              tdd.make_spk2utt().get("spk2utt").items()}
            res = run_score(cfg, args.exp_dir, args.trials,
                            os.path.join(args.exp_dir, "test.iv"),
                            os.path.join(args.exp_dir, "test.iv"),
                            cohort_ark=os.path.join(args.exp_dir, "train.iv"),
                            cohort_utt2spk=cohort_u2s,
                            enroll_spk2utt=enroll_s2u, device=dev)
            print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
