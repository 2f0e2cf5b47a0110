"""Stage-gated recipe driver of the port, on one card or on several.

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
a card and without ``--device cpu``, ``main`` raises.  Stage 1 mixes a data
dir's ``utt2aug`` copies on the card from MUSAN pools (``--musan-dir``) and
RIRS_NOISES room sets (``--rir-dir``).

Several cards: one process a card, started by ``utils/cluster.py``
(``launch_hosts``, ``slurm_script``) with the environment contract of
``parallel/distributed.py`` (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID, LOCAL_RANK); ``main`` joins the group first.  Stages 0, 1, 2,
5 and 6 are file work that rank 0 does once on the shared exp dir; stages 3
and 4 run on every rank (training over a (data, model) mesh with
``train.model_parallel`` ranks a class shard, extraction of each rank's
utterance shard into ``<name>.<rank>``); a barrier closes every stage.
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
    decode and utt2warp entries set the bucket's VTLN warp; utt2aug copies
    are mixed by `pools` (a recipes.augment_dir.AugmentPools on the same
    device) on the card, right before the frontend, one call per bucket
    (without pools they get clean features, with a warning).  Wav decode
    runs on an n_jobs thread pool (the nj-way fan-out of make_fbank.sh's
    run.pl jobs); augmentation and device work stay on the main thread, so
    the augmenter's numpy draws are deterministic; the dither draws come
    from one ``torch.Generator`` on the device seeded by `seed`.

    Buckets run through a one-deep pipeline: the card computes bucket k
    while the host CM-encodes bucket k−1 (its results are copied back into
    pinned memory behind bucket k's work)."""
    import contextlib
    import dataclasses

    from pkr_tpu_torch.frontend import FrontendConfig, wav_to_train_feats
    from pkr_tpu_torch.frontend.features import FbankConfig, num_frames
    from pkr_tpu_torch.io import DataDir, write_ark_scp
    from pkr_tpu_torch.io.wav import read_wav

    dev = resolve_device(device)
    if pools is not None and pools.device.type != dev.type:
        raise ValueError(f"the pools live on {pools.device}, the features on {dev}")
    dd = DataDir.load(data_dir)
    utt2aug = dd.get("utt2aug")
    if pools is None and any(k != "none" for k in utt2aug.values()):
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
            if pools is not None and utt2aug:
                # the whole bucket mixed on the card; the result feeds the
                # frontend there, with no copy to the host
                kinds = ([utt2aug.get(utt, "none") for utt, _ in items]
                         + ["none"] * (Bp - B))
                if any(k != "none" for k in kinds):
                    wavs = pools.augmenter(wavs, lens, kinds=kinds, device_out=True)
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

    if pools is not None and pools._rotate_rows:
        # pool-rotation record: a nonzero wait count means a slow disk kept
        # shards live past rotate_rows
        rec = {"pool_rotations_done": pools.rotations_done,
               "pool_rotation_wait_batches": pools.rotation_wait_batches,
               "pool_rotation_errors": pools.rotation_errors}
        with open(os.path.join(out_dir, "stage1_metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        if pools.rotation_wait_batches:
            print(f"  pool rotation: {pools.rotations_done} swaps, "
                  f"{pools.rotation_wait_batches} batches ran with a due "
                  "rotation waiting on prefetch")


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


class _TileToBatch:
    """Sampler wrapper: cycles a too-small split's indices up to one full
    mesh-divisible batch (see the cv-loader comment in run_train)."""

    def __init__(self, sampler, batch: int):
        self._sampler, self._batch = sampler, batch

    def __len__(self):
        return max(len(self._sampler), self._batch)

    def epoch_indices(self, epoch, seed, process_index=0, process_count=1):
        idx = self._sampler.epoch_indices(epoch, seed, process_index, process_count)
        if 0 < len(idx) < self._batch:
            idx = np.resize(np.asarray(idx), self._batch)
        return idx


def run_train(cfg, feat_dir: str, exp_dir: str, device: DeviceLike = None) -> None:
    """Stage 3 over the (data, model) mesh of every process
    (``train.model_parallel`` ranks a model row): ``train.batch_size`` is
    the global batch, each data shard's loader yields its share, and the
    flash head's weight is class-sharded where the rule splits it."""
    from pkr_tpu_torch.data import (BalancedRepetitionSampler, FeatureSource,
                                    SpeakerBalancedSampler, TrainLoader)
    from pkr_tpu_torch.parallel import batch_sharding, make_mesh, shard_params
    from pkr_tpu_torch.parallel.distributed import process_count, process_index
    from pkr_tpu_torch.train import create_train_state, train_and_validate
    from pkr_tpu_torch.train.checkpoint import (import_torch_checkpoint,
                                                load_pretrained,
                                                restore_checkpoint,
                                                save_checkpoint,
                                                wait_for_checkpoints)
    from pkr_tpu_torch.utils.logging import ProgressLogger

    dev = resolve_device(device)
    os.makedirs(exp_dir, exist_ok=True)
    num_spk = int(open(os.path.join(feat_dir, "num_spk")).read())
    model = build_model(cfg.model, num_spk, dev,
                        generator=torch.Generator().manual_seed(cfg.train.seed))
    mesh = make_mesh(n_model=cfg.train.model_parallel)
    n_data = mesh.n_data
    shard_index, shard_count = batch_sharding(mesh)

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
        # the global batch stays divisible by the data axis, and each data
        # shard's loader yields its share
        batch = min(cfg.train.batch_size, len(sampler))
        batch = max(n_data, batch // n_data * n_data) // n_data
        if split == "cv" and len(sampler) // n_data < batch:
            # fewer cv utts than the mesh-divisible minimum: tile indices up
            # to one full batch — a few double-counted utterances beat zero
            # validation batches (acc1 pinned at 0, no 'best' checkpoint)
            sampler = _TileToBatch(sampler, batch)
        if cfg.train.device_cache and split == "train" and isinstance(chunk, int):
            if n_data > 1:
                # one process a card: each data shard holds its round-robin
                # share of the corpus on its own card
                from pkr_tpu_torch.data import (ShardedCacheLoader,
                                                ShardedDeviceFeatureCache)

                cache = ShardedDeviceFeatureCache.from_scp(scp, u2id, mesh, device=dev)
                print(f"sharded device cache: {cache.nbytes_per_shard / 1e6:.1f} MB "
                      f"on this card (shard {shard_index} of {shard_count})")
                return ShardedCacheLoader(cache, batch * n_data, chunk,
                                          seed=cfg.train.seed)
            from pkr_tpu_torch.data import DeviceCacheLoader, DeviceFeatureCache

            cache = DeviceFeatureCache.from_scp(scp, u2id, device=dev)
            print(f"device cache: {cache.nbytes / 1e6:.1f} MB in device memory "
                  f"({len(src)} utterances)")
            return DeviceCacheLoader(cache, sampler, batch, chunk,
                                     seed=cfg.train.seed, device=dev)
        return TrainLoader(src, labels, sampler, batch, chunk, seed=cfg.train.seed,
                           process_index=shard_index, process_count=shard_count)

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

    if cfg.train.flash_aam:
        # the class rows of the flash head's weight over 'model', where the
        # rule splits them (checkpoints hold the whole weight: restore first)
        shard_params(model, mesh, state)
    # the metrics are global, the same on every rank: rank 0 keeps the record
    logger = ProgressLogger(
        jsonl_path=os.path.join(exp_dir, "train_metrics.jsonl")
        if process_index() == 0 else None,
        prefix=f"[rank {process_index()}] " if process_count() > 1 else "")

    def on_epoch_end(state, epoch, metrics):
        save_checkpoint(ckpt_dir, model, state, is_best=metrics["is_best"],
                        keep_last=cfg.train.keep_last_checkpoints, mesh=mesh)

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
                               keep_last=cfg.train.keep_last_checkpoints, mesh=mesh))
                           if cfg.train.save_every_steps else None,
                           profile_dir=cfg.train.profile_dir,
                           profile_steps=cfg.train.profile_steps, device=dev, mesh=mesh)
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

    from pkr_tpu_torch.parallel.distributed import barrier, process_count, process_index

    dev = resolve_device(device)
    pi, pc = process_index(), process_count()
    num_spk = int(open(os.path.join(feat_dir, "num_spk")).read())
    model = build_model(cfg.model, num_spk, dev)
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    restored = restore_checkpoint(ckpt_dir, model, which="best")
    if restored is None:
        restored = restore_checkpoint(ckpt_dir, model)
    if restored is None:
        raise RuntimeError(f"no checkpoint to extract from in {ckpt_dir}")
    if subset:
        sub_path = os.path.join(exp_dir, f"decode_{out_name}.scp")
        # rank 0 alone writes the subset scp (concurrent writes on shared
        # storage could hand a peer a torn file); select_decode_subset always
        # writes it, so after the barrier it reflects this run
        if pi == 0:
            select_decode_subset(scp, subset, cfg.train.seed, sub_path)
        if pc > 1:
            _wait_for_subset(sub_path, out_name)
        scp = sub_path
    # each rank extracts its utterance shard on its card into its own ark
    # (the reference's nj-way decode wrote per-job arks the same way;
    # load_text_vec_ark merges '<name>.<rank>' shards)
    loader = EvalLoader(FeatureSource(scp), batch_size=cfg.eval.batch_size,
                        quantum=cfg.eval.bucket_quantum, max_len=cfg.eval.max_len,
                        chunk_size=cfg.eval.chunk_size,
                        long_mode=cfg.eval.long_mode,
                        transport=cfg.eval.transport,
                        process_index=pi, process_count=pc)
    if pc > 1:
        # a stale single-process ark, or shards of a wider old run, would be
        # preferred or mixed in by the merge
        if pi == 0:
            import glob

            stale = [os.path.join(exp_dir, out_name)]
            for p in glob.glob(os.path.join(exp_dir, f"{out_name}.*")):
                suffix = p.rsplit(".", 1)[1]
                if suffix.isdigit() and int(suffix) >= pc:
                    stale.append(p)
            for p in stale:
                if os.path.exists(p):
                    os.unlink(p)
        barrier(f"extract-clean-{out_name}")
    embs = extract_embeddings(model, loader, device=dev)
    out = out_name if pc == 1 else f"{out_name}.{pi}"
    write_text_vec_ark(os.path.join(exp_dir, out), embs)


def _wait_for_subset(sub_path: str, out_name: str, timeout: float = 60.0) -> None:
    """Freshness of rank 0's subset scp on every rank: the file's existence
    is not enough (a previous run's satisfies it, and a stale NFS entry can
    serve old content after rank 0's rename).  Rank 0 broadcasts a nonce of
    this run and writes it to a stamp file after the scp; after the barrier
    a peer waits until it reads exactly this nonce back."""
    import time

    from pkr_tpu_torch.parallel.distributed import barrier, broadcast_object, process_index

    pi = process_index()
    nonce = broadcast_object(int(np.random.default_rng().integers(1, 2 ** 62)))
    stamp = sub_path + ".stamp"
    if pi == 0:
        tmp = stamp + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(nonce))
        os.replace(tmp, stamp)
    barrier(f"decode-subset-{out_name}")
    if pi == 0:
        return
    deadline = time.time() + timeout
    seen = None
    while time.time() < deadline:
        try:
            with open(stamp) as f:
                seen = f.read().strip()
        except OSError:
            seen = None
        if seen == str(nonce):
            return
        time.sleep(0.5)  # shared-storage visibility lag
    raise RuntimeError(f"rank {pi}: subset stamp {stamp} did not show this run's nonce "
                       f"within {timeout:.0f}s of the decode-subset barrier; refusing to "
                       "risk a stale subset scp (ranks would shard different lists)")


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
                    help="MUSAN root for utt2aug augmentation pools")
    ap.add_argument("--rir-dir", type=str, default=None,
                    help="RIRS_NOISES-style root for the utt2aug 'reverb' "
                         "branch (rir_list room sets; run.sh:93-130 role)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of every stage (default: the card; "
                         "'cpu' runs the plain PyTorch versions on the CPU)")
    args = ap.parse_args(argv)

    from pkr_tpu_torch.parallel.distributed import initialize, shutdown

    formed = initialize(device=args.device)  # the launchers' env contract
    try:
        return _main(args, resolve_device(args.device))  # this rank's card
    finally:
        if formed:
            shutdown()


def _main(args, dev) -> int:
    import dataclasses

    from pkr_tpu_torch.config import Config
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.parallel.distributed import barrier, process_count, process_index

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

    pools = None
    if ((args.musan_dir or args.rir_dir) and cfg.data.augment
            and 1 in _stage_range(args) and process_index() == 0):
        from pkr_tpu_torch.recipes.augment_dir import AugmentPools

        if args.musan_dir:
            from pkr_tpu_torch.recipes.voxceleb import make_musan

            # config SNR grids (DataConfig.snr_*, run.sh:136-144 defaults);
            # full-corpus pools with rotating device shards (DataConfig.pool_*)
            pools = AugmentPools.load(make_musan(args.musan_dir),
                                      seed=cfg.train.seed,
                                      snr={"noise": cfg.data.snr_noise,
                                           "music": cfg.data.snr_music,
                                           "babble": cfg.data.snr_babble},
                                      max_len_sec=cfg.data.pool_len_sec,
                                      shard_mb=cfg.data.pool_shard_mb,
                                      rotate_rows=cfg.data.pool_rotate_rows,
                                      device=dev)
        else:
            pools = AugmentPools(seed=cfg.train.seed, device=dev)
        if args.rir_dir:
            # run.sh:93-130: RIR-only reverberation (speech_rvb_prob 1, no
            # additive noises composed) from the RIRS_NOISES room sets
            pools.attach_rir_set(args.rir_dir)

    multi = process_count() > 1
    # stages 0/1/2/5/6 are file work: with several processes rank 0 does
    # them once on the shared exp dir; stages 3/4 run on every rank.  The
    # barrier after each stage keeps the ranks in step (without it rank 0
    # could score a half-written shard set)
    host_only = {0, 1, 2, 5, 6}
    for stage in _stage_range(args):
        if multi and stage in host_only and process_index() != 0:
            barrier(f"stage-{stage}")
            continue
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
                         seed=cfg.train.seed, pools=pools, frontend=cfg.frontend,
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
        if multi:
            barrier(f"stage-{stage}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
