"""Training traffic: a closed loop of the program's train steps fed by its
card-resident feature cache.

Set-up draws the corpus (CompressedMatrix codes and percentile tables) and
the weights on the card from the seed, hands them to the program
(``DeviceFeatureCache``, the balanced sampler, ``DeviceCacheLoader``,
``SpeakerModel`` through its state dict), builds one train step
(``make_train_step``, the dense or the flash AAM head as the configuration
says) and drives it through its first ``checked_steps`` steps on the
loader's first batches, which the reference follows; then
``warmup_steps`` more.  The window then runs the same step on the same
feed for ``--seconds``: a CUDA event after each step gives the step
intervals, the host clock from the first step's dispatch to the
synchronize after the last gives the rate.  With ``--trace 1`` the window
also times each batch the loader yields and traces a steady stretch with
the profiler; with the flash head, a second stretch right after it times
the head's forward and backward (CUDA events around the program's call).
Neither stretch, nor the step after them, counts in ``train_mfu``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import compare
from portbench.arith.resnet import train_flops
from portbench.build import build_model, make_corpus, make_weights
from portbench.reference import crops as ref_crops
from portbench.reference import lowp, resnet as ref_resnet
from portbench.reference.train import train_steps
from portbench.trace import Spans, Ticks, p95, steady_trace, summarize


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].detach().to(torch.float32))
                        for n in names]).tolist()
    return dict(zip(names, vals))


def _epochs(loader):
    epoch = 0
    while True:
        yield from loader.epoch(epoch)
        epoch += 1


class _FlashSpans:
    """CUDA events around the flash head's forward and backward, as the
    train step calls it: the train step reaches the head through the name
    ``flash_aam_loss_acc`` of ``pkr_tpu_torch.train.loop``, which this
    rebinds to a wrapper for the window and restores after.  The backward
    span opens when the loss's gradient reaches the head and closes when
    the gradients of its two inputs leave it."""

    def __init__(self, spans: Spans):
        import pkr_tpu_torch.train.loop as loop

        self.loop, self.orig, self.spans = loop, loop.flash_aam_loss_acc, spans
        spans_ = spans

        class Leave(torch.autograd.Function):
            @staticmethod
            def forward(ctx, e, w):
                return e.view_as(e), w.view_as(w)

            @staticmethod
            def backward(ctx, ge, gw):
                spans_.stop("flash_bwd")
                return ge, gw

        class Enter(torch.autograd.Function):
            @staticmethod
            def forward(ctx, loss):
                return loss.view_as(loss)

            @staticmethod
            def backward(ctx, g):
                spans_.start("flash_bwd")
                return g

        def timed(e, w, y, m, s):
            e, w = Leave.apply(e, w)
            spans_.start("flash_fwd")
            loss, acc1, acc5 = self.orig(e, w, y, m, s)
            spans_.stop("flash_fwd")
            return Enter.apply(loss), acc1, acc5

        self.timed = timed

    def __enter__(self):
        self.loop.flash_aam_loss_acc = self.timed
        return self

    def __exit__(self, *exc):
        self.loop.flash_aam_loss_acc = self.orig

    def check(self) -> None:
        """Raise where the stretch recorded no span of the head: the train
        step no longer reaches it through the rebound name."""
        for name in ("flash_fwd", "flash_bwd"):
            if not self.spans.pairs.get(name):
                raise RuntimeError(
                    f"no {name} span: the train step did not call "
                    "pkr_tpu_torch.train.loop.flash_aam_loss_acc, so the flash head "
                    "cannot be timed")


def prepare(ctx):
    """Everything before the window: the program's objects, its first
    steps and what they read.  Returns a dict the window and the
    comparison take."""
    from pkr_tpu_torch.data.device_cache import DeviceCacheLoader, DeviceFeatureCache
    from pkr_tpu_torch.data.sampler import BalancedRepetitionSampler
    from pkr_tpu_torch.train import create_train_state, make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ctx.mark("imports")
    corpus = make_corpus(cfg["corpus"], cfg["feat_dim"], ctx.seed, dev)
    cache = DeviceFeatureCache(corpus.codes, corpus.pct, corpus.offsets, corpus.rows,
                               corpus.utts, corpus.labels)
    sampler = BalancedRepetitionSampler(corpus.utts, corpus.labels, tr["max_per_class"])
    loader = DeviceCacheLoader(cache, sampler, tr["batch"], chunk=tr["frames"],
                               seed=ctx.seed, device=dev)
    ctx.mark("corpus and loader")
    weights = make_weights(cfg, ctx.seed, dev)
    model = build_model(cfg, weights, dev)
    state = create_train_state(model)
    step = make_train_step(model, tr["momentum"], tr["weight_decay"],
                           flash_aam=cfg["head"] == "flash", device=dev)
    step = ctx.hooks.get("step", lambda f, m: f)(step, model)  # a test plants faults here
    feed = _epochs(loader)
    params = dict(model.named_parameters())
    stats = {n: b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    lr, wd = tr["lr"], tr["weight_decay"]
    ctx.mark("model and step")
    batches, metrics, prog = [], [], {}
    for k in range(tr["checked_steps"]):
        x, y = next(feed)
        batches.append((x, y))
        state, met = step(state, x, y, lr)
        metrics.append({key: v.detach() for key, v in met.items()})
        if k == 0:
            prog["grad1"] = _norms({n: state.momentum[n] - wd * weights[n] for n in params})
    prog["change"] = _norms({n: params[n] - weights[n] for n in params})
    prog["mom"] = _norms(state.momentum)
    prog["bnstat"] = _norms({n: stats[n] - weights[n] for n in stats})
    for key in ("loss", "acc1", "acc5"):
        prog[key] = [float(m[key]) for m in metrics]
    del weights
    ctx.mark("checked steps")
    for _ in range(tr["warmup_steps"]):
        state, _ = step(state, *next(feed), lr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up steps")
    return {"corpus": corpus, "model": model, "state": state, "step": step, "feed": feed,
            "batches": batches, "prog": prog,
            "program": [cache, sampler, loader]}


def window(ctx, s: dict) -> dict:
    """The measured window on the prepared step and feed."""
    tr, dev, cfg = ctx.traffic, ctx.device, ctx.config
    step, feed, lr = s["step"], s["feed"], tr["lr"]
    ticks, spans = Ticks(dev), Spans(dev)
    losses: List[torch.Tensor] = []
    st = {"state": s["state"]}

    def one():
        if ctx.trace:
            spans.start("loader")
        x, y = next(feed)
        if ctx.trace:
            spans.stop("loader")
        st["state"], met = step(st["state"], x, y, lr)
        ticks.tick()
        losses.append(met["loss"])

    def stretch():
        for _ in range(tr["trace_steps"]):
            one()

    summary, traced = None, (0, 0)
    flash = _FlashSpans(spans) if (ctx.trace and cfg["head"] == "flash") else None
    ticks.tick()
    t_start = time.perf_counter()
    while True:
        if ctx.trace and summary is None and len(losses) >= tr["trace_after"]:
            first = len(losses)
            summary = summarize(steady_trace(stretch))
            if flash is not None:
                with flash:
                    stretch()
            traced = (first, len(losses))
        else:
            one()
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    if flash is not None and summary is not None:
        flash.check()
    loss_vals = torch.stack(losses).tolist()
    intervals = ticks.intervals_ms()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n, B = len(loss_vals), tr["batch"]
    e2e = {"train_examples_per_s": n * B / (t_end - t_start),
           "train_step_ms_p95": p95(intervals)}
    records = {"kind": "train", "step_ms": intervals,
               # the step after the stretches waits for the trace's reading
               "untraced_step_ms": intervals[:traced[0]] + intervals[traced[1] + 1:],
               "train_flops": train_flops(cfg["trunk"], cfg["feat_dim"], tr["frames"],
                                          cfg["emb_dim"], cfg["n_spk"], B)}
    if ctx.trace:
        records["loader_ms"] = spans.ms("loader")
        records["trace"] = summary
        records["trace_steps"] = tr["trace_steps"]  # the summary is of one stretch
        if flash is not None:
            records["flash_fwd_ms"] = spans.ms("flash_fwd")
            records["flash_bwd_ms"] = spans.ms("flash_bwd")
            records["flash_shape"] = (B, cfg["n_spk"], cfg["emb_dim"])
    return {"attempted": n, "failed": sum(not math.isfinite(v) for v in loss_vals),
            "e2e": e2e, "records": records, "memory_peak_bytes": peak,
            "summary": summary, "window_host_s": t_end - t_start}


def reference(ctx, s: dict, conv=ref_resnet.f32_conv, batch_rows=None,
              zero_grad=()) -> dict:
    """The reference's first steps on the crops it works out itself from
    the benchmark's corpus and seed; returns its readings and its crops."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    c = s["corpus"]
    batches = ref_crops.crops(c.codes, c.pct, c.offsets, c.rows, c.labels, tr["max_per_class"],
                              ctx.seed, tr["batch"], tr["frames"], tr["checked_steps"])
    weights = make_weights(cfg, ctx.seed, dev)
    out = train_steps(weights, cfg, batches, tr["lr"], tr["momentum"], tr["weight_decay"],
                      conv=conv, batch_rows=batch_rows, zero_grad=zero_grad)
    out["batches"] = batches
    return out


HEAD_LEAVES = ("fc1.weight", "fc1.bias", "last.weight")  # reported by calibration


def outside_bn(ref: dict, leaves: List[str]) -> List[str]:
    """The ``leaves`` of no BatchNorm layer (a layer with running
    statistics): the convolutions, fc1 and the AAM weight."""
    bn = {n.rsplit(".", 1)[0] for n in ref["bnstat"]}
    return [n for n in leaves if n.rsplit(".", 1)[0] not in bn]


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: the crops (largest difference; inf where a
    label differs), each step's loss, and of the first gradient and, after
    the checked steps, of the parameters' change and the momentum both the
    median leaf's gap and the worst gap over the leaves outside BatchNorm
    (each against the larger of its leaf's and the median leaf's norm)."""
    crops = 0.0
    for (xp, yp), (xr, yr) in zip(prog["batches"], ref["batches"]):
        if not torch.equal(yp.to(yr.device), yr):
            crops = math.inf
            break
        crops = max(crops, float((xp.to(xr.device) - xr).abs().max()))
    kept = compare.kept_leaves(ref["grad1"])
    weights = outside_bn(ref, kept)
    out = {"crops_gap": crops, "loss_gap": compare.rel_gap(prog["loss"], ref["loss"])}
    for key, name in (("grad1", "grad"), ("change", "change"), ("mom", "mom")):
        gaps = compare.leaf_gaps(prog[key], ref[key], kept)
        out[f"{name}_med"] = float(np.median(list(gaps.values())))
        out[f"{name}_worst"] = max(gaps[n] for n in weights)
    return out


def bnstat_med(prog: dict, ref: dict) -> float:
    """The median leaf's gap of the BatchNorm statistics' change: read by
    calibration, not compared (neither the control nor a fault reads it
    far enough above sound runs)."""
    return compare.median_gap(prog["bnstat"], ref["bnstat"])


def free_program(s: dict) -> None:
    """Drop the program's state (model, momentum, step, cache, loader) so
    the reference runs in the memory it leaves."""
    for key in ("model", "state", "step", "feed", "program"):
        s.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def calibrate(ctx, control: bool):
    """Readings without a window (``portbench/calibrate.py``): the sound
    run's and, with ``control``, the fp8 control's and the faults' (half of
    each batch left out; the AAM weight's gradient taken as zero; the AAM
    weight's or fc1's state left unchanged, worked out from the
    reference's own readings), each against the f32 reference."""
    s = prepare(ctx)
    free_program(s)
    ref = reference(ctx, s)
    prog = dict(s["prog"], batches=s["batches"])

    def row(kind, other):
        return {"kind": kind, **readings(other, ref), "bnstat_med": bnstat_med(other, ref),
                "where": worst_leaves(other, ref)}

    yield dict(row("sound", prog), loss=prog["loss"], ref_loss=ref["loss"],
               acc1=prog["acc1"], ref_acc1=ref["acc1"], acc5=prog["acc5"], ref_acc5=ref["acc5"])
    if control:
        yield row("control_fp8", reference(ctx, s, conv=lowp.fp8_conv))
        yield row("fault_half_batch",
                  reference(ctx, s, batch_rows=slice(0, ctx.traffic["batch"] // 2)))
        yield row("fault_head_dw0", reference(ctx, s, zero_grad=("last.weight",)))
        for kind, leaves in (("fault_head_unchanged", ("last.weight",)),
                             ("fault_fc1_unchanged", ("fc1.weight", "fc1.bias"))):
            still = {k: dict(ref[k]) for k in ("grad1", "change", "mom", "bnstat")}
            for n in leaves:
                still["change"][n] = still["mom"][n] = 0.0
            yield row(kind, dict(ref, **still))


def worst_leaves(prog: dict, ref: dict) -> Dict[str, list]:
    """Per kind, the worst leaf's gap and name over every kept leaf and over
    those outside BatchNorm, and the gaps of fc1's and the AAM weight's
    leaves (reported by calibration)."""
    kept = compare.kept_leaves(ref["grad1"])
    weights = outside_bn(ref, kept)
    out = {}
    for k in ("grad1", "change", "mom"):
        gaps = compare.leaf_gaps(prog[k], ref[k], kept)
        at = max(gaps, key=gaps.get)
        at_w = max(weights, key=gaps.get)
        out[k] = {"all": [gaps[at], at], "outside_bn": [gaps[at_w], at_w],
                  **{n: gaps[n] for n in HEAD_LEAVES if n in gaps}}
    out["bnstat"] = list(compare.norm_gap(prog["bnstat"], ref["bnstat"]))
    return out


def run(ctx) -> dict:
    s = prepare(ctx)
    setup_s = time.perf_counter() - ctx.t0
    out = window(ctx, s)
    out["e2e"]["setup_s"] = setup_s
    free_program(s)
    ref = reference(ctx, s)
    prog = dict(s["prog"], batches=s["batches"])
    correct, rows = compare.check(readings(prog, ref), ctx.limits.get("checks", {}))
    summary = out.pop("summary")
    out.update(correct=correct, checks=rows,
               busy_s=summary["busy_s"] if summary else None,
               window_s=summary["window_s"] if summary else None,
               breakdown=summary["breakdown"] if summary else None)
    return out
