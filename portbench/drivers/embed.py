"""Extraction traffic: one client, wav to embedding, a closed loop that
keeps up to ``in_flight`` batches on the card as ``extract_embeddings``
does.

Set-up makes ``pool_batches`` batches of synthetic wavs on the host from
the seed (a sine of 80-300 Hz at amplitude 3000 plus Gaussian noise of
400, int16 scale, every utterance the same length), the weights on the
card, and the program's model and ``make_embed_fn``; then runs every
batch of the pool once (the shapes' warm-up).  Batch k of the window is
pool batch k mod ``pool_batches`` with its own dither draws (a generator
seeded from the seed and k).  A batch is handed to the program as host
float32 wavs: ``wav_to_train_feats`` (framing, fbank, VAD, CMVN, voiced
selection), then ``embed`` on the (B, F, T) features and mask; its
embeddings are copied to the host once ``in_flight`` batches are
pending.  A batch's latency runs from its hand-off to its embeddings on
the host; the rate counts the utterances whose embeddings reached the
host over the window.  After the window, ``checked_batches`` batches
drawn from the seed among the window's are compared with the reference:
their features and mask, and their embeddings.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from portbench import compare
from portbench.arith.frontend import fbank_flops
from portbench.arith.resnet import embed_flops
from portbench.build import build_model, make_weights, sub_seed
from portbench.reference import frontend as ref_frontend
from portbench.reference import lowp, resnet as ref_resnet
from portbench.reference import strict_f32
from portbench.trace import Spans, p95, steady_trace, summarize


def make_wavs(tr: dict, seed: int, index: int) -> np.ndarray:
    """One batch of the pool: (B, N) float32, int16 scale."""
    rng = np.random.default_rng(sub_seed(seed, 10 + index))
    n = int(tr["seconds_per_utt"] * tr["rate"])
    t = np.arange(n) / tr["rate"]
    f = rng.uniform(tr["f_lo"], tr["f_hi"], size=(tr["batch"], 1))
    sig = (tr["amp"] * np.sin(2 * np.pi * f * t[None, :])).astype(np.float32)
    sig += np.float32(tr["noise"]) * rng.standard_normal((tr["batch"], n), dtype=np.float32)
    return sig


def _dither_gen(dev, seed: int, k: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(sub_seed(seed, 100 + k))


def prepare(ctx) -> dict:
    from pkr_tpu_torch.eval.extract import make_embed_fn
    from pkr_tpu_torch.frontend import FrontendConfig, wav_to_train_feats
    from pkr_tpu_torch.frontend.features import FbankConfig

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ctx.mark("imports")
    pool = [make_wavs(tr, ctx.seed, i) for i in range(tr["pool_batches"])]
    ctx.mark("wavs")
    lengths = np.full((tr["batch"],), pool[0].shape[1], np.int64)
    weights = make_weights(cfg, ctx.seed, dev)
    model = build_model(cfg, weights, dev)
    del weights
    embed = make_embed_fn(model, dev)
    fcfg = FrontendConfig(fbank=FbankConfig(dither=tr["dither"]))

    def frontend(k: int):
        feats, mask, _ = wav_to_train_feats(pool[k % len(pool)], lengths,
                                            _dither_gen(dev, ctx.seed, k), fcfg, device=dev)
        return feats, mask

    def embed_batch(feats, mask):
        return embed(feats.permute(0, 2, 1).contiguous(), mask)

    embed_batch = ctx.hooks.get("embed", lambda f: f)(embed_batch)  # a test plants faults here
    ctx.mark("model")
    for k in range(len(pool)):  # every shape the window uses
        embed_batch(*frontend(k)).cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up")
    return {"pool": pool, "lengths": lengths, "model": model, "frontend": frontend,
            "embed": embed_batch}


def checked_indices(tr: dict, seed: int, first: int) -> List[int]:
    rng = np.random.default_rng(sub_seed(seed, 4))
    return sorted(int(k) for k in rng.choice(np.arange(first, first + tr["check_span"]),
                                             tr["checked_batches"], replace=False))


def window(ctx, s: dict) -> dict:
    tr, dev, cfg = ctx.traffic, ctx.device, ctx.config
    frontend, embed_batch = s["frontend"], s["embed"]
    spans = Spans(dev)
    checked = set(checked_indices(tr, ctx.seed, len(s["pool"])))
    kept: Dict[int, dict] = {}
    pending: deque = deque()
    latencies: List[float] = []
    done = {"utts": 0, "batches": 0, "bad": 0}
    frames = {}

    def finish():
        k, t_hand, emb = pending.popleft()
        host = emb.cpu().numpy()
        latencies.append((time.perf_counter() - t_hand) * 1e3)
        done["utts"] += host.shape[0]
        done["batches"] += 1
        done["bad"] += int((~np.isfinite(host).all(axis=1)).sum())
        if k in kept:
            kept[k]["emb"] = host

    def one(k: int):
        t_hand = time.perf_counter()
        if ctx.trace:
            spans.start("frontend")
        feats, mask = frontend(k)
        if ctx.trace:
            spans.stop("frontend")
        emb = embed_batch(feats, mask)
        frames["T"] = feats.shape[1]
        if k in checked:
            kept[k] = {"feats": feats, "mask": mask}
        pending.append((k, t_hand, emb))
        if len(pending) >= tr["in_flight"]:
            finish()

    k = len(s["pool"])  # the window's batches follow the warm-up's
    summary, paused = None, (0, 0.0)
    t_start = time.perf_counter()
    while True:
        if ctx.trace and summary is None and k - len(s["pool"]) >= tr["trace_after"]:
            def stretch():
                nonlocal k
                for _ in range(tr["trace_batches"]):
                    one(k)
                    k += 1
            k0, t0 = k, time.perf_counter()
            summary = summarize(steady_trace(stretch))
            paused = (k - k0, time.perf_counter() - t0)  # traced batches, and the wait
        else:
            one(k)
            k += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    while pending:
        finish()
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    B = tr["batch"]
    T = frames["T"]
    e2e = {"embed_utts_per_s": done["utts"] / (t_end - t_start),
           "embed_batch_ms_p95": p95(latencies)}
    records = {"kind": "embed", "batches": done["batches"] - paused[0],
               "window_s": t_end - t_start - paused[1],
               "batch_flops": (fbank_flops(B, T, mels=cfg["feat_dim"])
                               + embed_flops(cfg["trunk"], cfg["feat_dim"], T, cfg["emb_dim"], B))}
    if ctx.trace:
        records["frontend_ms"] = spans.ms("frontend")
        records["trace"] = summary
    return {"attempted": done["utts"], "failed": done["bad"], "e2e": e2e, "records": records,
            "memory_peak_bytes": peak, "summary": summary, "kept": kept}


def reference(ctx, s: dict, k: int, control: bool = False) -> dict:
    """The reference's features, mask and embeddings of window batch k;
    ``control``: its TF32 frontend and fp8 trunk."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    wav = torch.as_tensor(s["pool"][k % len(s["pool"])], device=dev)
    feats, mask = ref_frontend.features(wav, wav.shape[1], _dither_gen(dev, ctx.seed, k),
                                        tr["dither"], tf32=control)
    weights = make_weights(cfg, ctx.seed, dev)
    conv = lowp.fp8_conv if control else ref_resnet.f32_conv
    with strict_f32(), torch.no_grad():
        emb = ref_resnet.embed(weights, cfg, feats.permute(0, 2, 1), False, mask, conv=conv)
    return {"feats": feats, "mask": mask, "emb": emb.cpu().numpy()}


def readings(prog: Dict[int, dict], ref: Dict[int, dict]) -> Dict[str, float]:
    """The largest feature difference over the valid frames (inf where a
    mask differs or a batch never came back) and the worst utterance's
    relative embedding error."""
    feats, emb = 0.0, 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if (p is None or "emb" not in p or p["emb"].shape != r["emb"].shape
                or not torch.equal(p["mask"].to(r["mask"].device), r["mask"])):
            return {"feats_gap": math.inf, "emb_gap": math.inf}
        d = (p["feats"].to(r["feats"].device, torch.float32) - r["feats"]).abs()
        feats = max(feats, float(d[r["mask"]].max()))
        err = np.linalg.norm(p["emb"] - r["emb"], axis=1) / np.linalg.norm(r["emb"], axis=1)
        emb = max(emb, float(np.max(err)) if np.isfinite(err).all() else math.inf)
    return {"feats_gap": feats, "emb_gap": emb}


def free_program(s: dict) -> None:
    for key in ("model", "frontend", "embed"):
        s.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def calibrate(ctx, control: bool):
    """Readings without a window: the program's and, with ``control``, the
    control's on the batches a window would check."""
    s = prepare(ctx)
    ks = checked_indices(ctx.traffic, ctx.seed, len(s["pool"]))
    prog = {}
    for k in ks:
        feats, mask = s["frontend"](k)
        prog[k] = {"feats": feats, "mask": mask, "emb": s["embed"](feats, mask).cpu().numpy()}
    free_program(s)
    ref = {k: reference(ctx, s, k) for k in ks}
    yield {"kind": "sound", **readings(prog, ref)}
    if control:
        low = {k: reference(ctx, s, k, control=True) for k in ks}
        yield {"kind": "control_tf32_fp8", **readings(low, ref)}


def run(ctx) -> dict:
    s = prepare(ctx)
    setup_s = time.perf_counter() - ctx.t0
    out = window(ctx, s)
    out["e2e"]["setup_s"] = setup_s
    kept = out.pop("kept")
    free_program(s)
    # every batch drawn for the comparison, whether or not the window reached it:
    # one that never came back reads inf
    ref = {k: reference(ctx, s, k)
           for k in checked_indices(ctx.traffic, ctx.seed, len(s["pool"]))}
    correct, rows = compare.check(readings(kept, ref), ctx.limits.get("checks", {}))
    summary = out.pop("summary")
    out.update(correct=correct, checks=rows,
               busy_s=summary["busy_s"] if summary else None,
               window_s=summary["window_s"] if summary else None,
               breakdown=summary["breakdown"] if summary else None)
    return out
