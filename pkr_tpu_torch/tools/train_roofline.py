"""Train-step roofline on the H100: how far is the flagship step from the
least time the card could take, and where is the gap?

The H100 counterpart of ``tools/train_roofline.py``, whose bound (the v5e
MXU's output-lane occupancy) means nothing on this card.  At the recipe
crop, B = 256 × 40 mels × 200 frames, ResNet-34 with the dense AAM head
over 7325 speakers and the bf16 trunk:

  1. every convolution's three passes (forward, dgrad, wgrad), each bounded
     by max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s), its bytes the pass's
     least traffic: its two operands read once and its result written once,
     in the dtypes the port's bf16 step holds them in (wgrad's result in
     f32, the parameter's gradient); the stem's dgrad is not run (the
     features need no gradient);
  2. the rest by the least bytes each must move: train-mode BatchNorm
     forward and backward, the ReLUs, the residual adds (and the gradient
     join at each block's input), the stats pool, the SGD update, counted
     from the port's own tensors (forward hooks on the modules of
     ``pkr_tpu_torch.models`` record shapes and dtypes under the model's
     autocast; the parameter count gives the update), and the head's f32
     GEMMs (fc1 and the cosines) at the f32 peak of 67 TFLOP/s; cuDNN's
     layout transposes have a floor of 0 (a step in one layout needs none);
  3. on the card, the forward-only loss and the full step timed with CUDA
     events over windows (the best of ``--repeats`` windows of ``--iters``
     calls, as the JAX tool's ``measure``), and the step's device time from
     ``torch.profiler`` summed into buckets by kernel name: convolution,
     BatchNorm, layout transposes, other elementwise, optimizer and head.

Prints one JSON line: each bucket's measured ms beside its floor, the
whole-step floor, step_over_fwd, the conv-MFU against 989 TFLOP/s and the
card's name and power limit.  ``--no-measure`` prints only the analytic
part and needs no card (the hooks then run on the CPU at a batch of 2,
scaled).

Run: python -m pkr_tpu_torch.tools.train_roofline [--iters N] [--repeats R]
[--no-measure]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device

B, F, T = 256, 40, 200
SPK, EMB = 7325, 256
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 on the tensor cores,
# f32 outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
BUCKETS = ("convolution", "batchnorm", "layout", "elementwise", "optimizer", "head")


class Conv(NamedTuple):
    """One convolution of the trunk: its module path, kernel, stride,
    channels and input and output geometry (one example)."""

    name: str
    k: int
    stride: int
    c_in: int
    c_out: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int

    @property
    def flops(self) -> float:
        """FLOPs of one pass for one example."""
        return 2.0 * self.k * self.k * self.c_in * self.c_out * self.h_out * self.w_out


def conv_geometry(feat_dim: int = F, frames: int = T) -> List[Conv]:
    """Every conv of the recipe resnet34 trunk at the training crop, in the
    order the forward runs them: the stem, the 3/4/6/3 blocks of two 3x3
    convs, and the 1x1 downsample at each stage transition (after the
    block's conv2, as ``BasicBlock.forward`` calls it)."""
    layers = []
    h, w = feat_dim, frames
    layers.append(Conv("res.conv1", 3, 1, 1, 32, h, w, h, w))  # stem
    chans, blocks, strides = [32, 64, 128, 256], [3, 4, 6, 3], [1, 2, 2, 2]
    cin = 32
    for li, (c, nb, s) in enumerate(zip(chans, blocks, strides), 1):
        h_in, w_in = h, w
        if s == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        for b in range(nb):
            pre = f"res.layer{li}.{b}"
            first = b == 0
            layers.append(Conv(f"{pre}.conv1", 3, s if first else 1, cin if first else c, c,
                               h_in if first else h, w_in if first else w, h, w))
            layers.append(Conv(f"{pre}.conv2", 3, 1, c, c, h, w, h, w))
            if first and (s != 1 or cin != c):
                layers.append(Conv(f"{pre}.downsample.0", 1, s, cin, c, h_in, w_in, h, w))
        cin = c
    return layers


def conv_layers():
    """(flops_one_pass, c_in, c_out) for every conv, one example, as the JAX
    tool lists them."""
    return [(c.flops, c.c_in, c.c_out) for c in conv_geometry()]


def linear_layers(spk: int = SPK, feat_dim: int = F):
    """(flops_one_pass, d_in, d_out) of fc1 (the pooled 2·256·F/8 statistics
    to 256) and the AAM head (256 to spk cosines), one example."""
    d_in = 2 * 256 * ((feat_dim + 7) // 8)
    return [(2.0 * d_in * EMB, d_in, EMB), (2.0 * EMB * spk, EMB, spk)]


def train_flops(batch: int = B, spk: int = SPK) -> float:
    """FLOPs of one training step by the MFU convention (fwd + bwd = 3× fwd,
    convolutions and matmuls only): bench.py's ``resnet34_train_flops``."""
    return 3.0 * batch * (sum(f for f, _, _ in conv_layers())
                          + sum(f for f, _, _ in linear_layers(spk)))


class Item(NamedTuple):
    """One pass of one operation with its least work: the bucket it belongs
    to, its FLOPs and peak, its bytes."""

    bucket: str
    name: str
    flops: float
    peak: float
    nbytes: float

    @property
    def ms(self) -> float:
        return 1e3 * max(self.flops / self.peak, self.nbytes / PEAK_BYTES)

    @property
    def bound_by(self) -> str:
        return "operations" if self.flops / self.peak >= self.nbytes / PEAK_BYTES else "bytes"


def conv_items(batch: int = B, act: int = 2, wgrad_out: int = 4) -> List[Item]:
    """Forward, dgrad and wgrad of every conv at ``batch``: activations and
    weights in ``act``-byte (bf16) elements, wgrad's result in
    ``wgrad_out``-byte (f32) elements; no dgrad for the stem."""
    items = []
    for c in conv_geometry():
        x = batch * c.c_in * c.h_in * c.w_in * act
        y = batch * c.c_out * c.h_out * c.w_out * act
        wt = c.c_out * c.c_in * c.k * c.k
        f = batch * c.flops
        items.append(Item("convolution", f"{c.name}.fwd", f, PEAK_BF16, x + wt * act + y))
        if c.name != "res.conv1":
            items.append(Item("convolution", f"{c.name}.dgrad", f, PEAK_BF16, y + wt * act + x))
        items.append(Item("convolution", f"{c.name}.wgrad", f, PEAK_BF16,
                          y + x + wt * wgrad_out))
    return items


def census(model, batch: int = 2) -> Dict:
    """Shapes and dtypes of the trunk's tensors in one train-mode forward of
    ``model`` at ``batch`` (random inputs on its device, its own autocast):
    each BatchNorm's input and output, each block's input and output, the
    trunk's output map and fc1's input, by forward hooks."""
    from pkr_tpu_torch.models.resnet import BasicBlock, BatchNorm, Bottleneck

    dev = next(model.parameters()).device
    rec = {"bn": [], "block": [], "fmap": None, "pooled": None}
    hooks = []

    def meta(t):
        return (tuple(t.shape), t.dtype)

    for name, mod in model.res.named_modules():
        if isinstance(mod, BatchNorm):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: rec["bn"].append((name, meta(i[0]), meta(o)))))
        elif isinstance(mod, (BasicBlock, Bottleneck)):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: rec["block"].append((name, meta(i[0]), meta(o)))))
    hooks.append(model.res.register_forward_hook(
        lambda m, i, o: rec.__setitem__("fmap", meta(o))))
    hooks.append(model.fc1.register_forward_hook(
        lambda m, i, o: rec.__setitem__("pooled", meta(i[0]))))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch, model.feat_dim, T), generator=gen, device=dev)
    labels = torch.randint(0, model.spk_num, (batch,), generator=gen, device=dev)
    was_training = model.training
    try:
        model.train()
        with torch.no_grad():
            model(x, labels)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    staged = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in staged:  # the census commits nothing
        m.staged = None
    rec["batch"] = batch
    return rec


def _bytes(meta, scale: float) -> float:
    shape, dtype = meta
    return float(np.prod(shape)) * scale * dtype.itemsize


def rest_items(rec: Dict, n_params_bytes: float, batch: int = B, spk: int = SPK) -> List[Item]:
    """The least bytes of everything but the convolutions, from a census
    scaled to ``batch``: BatchNorm (forward reads x, writes y; backward
    reads dy and x, writes dx), ReLU after each bn1 and each block
    (forward reads x, writes y; backward reads dy and y, writes dx), each
    residual add (reads two, writes one) and the gradient join at each
    block's input (the same), the stats pool (reads the map, writes the
    statistics; backward reads their gradient and the map, writes its
    gradient), the SGD update (reads parameter, gradient and momentum,
    writes parameter and momentum: ``n_params_bytes`` is their f32 bytes
    once), and the head's f32 GEMMs (fc1, the cosines; each pass reads its
    operands once and writes its result once) with the loss reading the
    logits and writing their gradient once."""
    s = batch / rec["batch"]
    items = []
    for name, x, y in rec["bn"]:
        items.append(Item("batchnorm", f"{name}.fwd", 0.0, PEAK_BF16,
                          _bytes(x, s) + _bytes(y, s)))
        items.append(Item("batchnorm", f"{name}.bwd", 0.0, PEAK_BF16,
                          _bytes(y, s) + 2 * _bytes(x, s)))
        if name.rsplit(".", 1)[-1] == "bn1":  # the stem's and each block's ReLU
            items.append(Item("elementwise", f"{name}.relu", 0.0, PEAK_BF16,
                              5 * _bytes(y, s)))
    for name, x, y in rec["block"]:
        items.append(Item("elementwise", f"res.{name}.add_relu", 0.0, PEAK_BF16,
                          3 * _bytes(y, s) + 5 * _bytes(y, s)))
        items.append(Item("elementwise", f"res.{name}.grad_join", 0.0, PEAK_BF16,
                          3 * _bytes(x, s)))
    fmap, pooled = _bytes(rec["fmap"], s), _bytes(rec["pooled"], s)
    items.append(Item("elementwise", "stats_pool", 0.0, PEAK_BF16, 2 * fmap + 2 * pooled))
    items.append(Item("optimizer", "sgd", 0.0, PEAK_BF16, 5 * n_params_bytes))
    for (f, d_in, d_out), name in zip(linear_layers(spk), ("fc1", "aam")):
        x, y, w = 4.0 * batch * d_in, 4.0 * batch * d_out, 4.0 * d_in * d_out
        for p in ("fwd", "dgrad", "wgrad"):
            items.append(Item("head", f"{name}.{p}", batch * f, PEAK_F32, x + y + w))
    items.append(Item("head", "aam.loss", 0.0, PEAK_F32, 2 * 4.0 * batch * spk))
    return items


def floors(items: Sequence[Item]) -> Dict[str, float]:
    out = dict.fromkeys(BUCKETS, 0.0)
    for it in items:
        out[it.bucket] += it.ms
    return out


def bucket_of(name: str) -> str:
    """The bucket of a device activity, by its kernel name."""
    n = name.lower()
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout"
    if "batch_norm" in n or "bn_fw" in n or "bn_bw" in n:
        return "batchnorm"
    if any(k in n for k in ("conv", "implicit_gemm", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if "multi_tensor_apply" in n:
        return "optimizer"
    if any(k in n for k in ("gemm", "gemv", "softmax", "nll_loss", "topk", "sort")):
        return "head"
    return "elementwise"


def trace_buckets(fn, calls: int):
    """Device time of one call by bucket (ms), its total and its activities,
    and the three longest kernels of each bucket, from one torch.profiler
    trace of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(BUCKETS, 0.0)
    by_name: Dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = e.time_range.elapsed_us() / 1e3 / calls
            ms[bucket_of(e.name)] += t
            by_name[e.name] = by_name.get(e.name, 0.0) + t
            n += 1
    top = {b: [] for b in BUCKETS}
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if len(top[bucket_of(name)]) < 3:
            top[bucket_of(name)].append([name[:70], t])
    return ms, sum(ms.values()), n / calls, top


def _windows_ms(fn, iters: int, repeats: int) -> float:
    """The best of ``repeats`` windows of ``iters`` calls, ms a call, by CUDA
    events."""
    best = float("inf")
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def build_model(device: DeviceLike = None):
    """The flagship: ResNet-34, mean+std, the dense AAM head over 7325
    speakers, bf16 trunk, seeded."""
    from pkr_tpu_torch.models import SpeakerModel

    torch.manual_seed(0)
    return SpeakerModel(SPK, F, "mean+std", "AAM", trunk="resnet34", dtype=torch.bfloat16,
                        device=device)


def measure(model=None, iters: int = 20, repeats: int = 3, profile_steps: int = 3,
            device: DeviceLike = None) -> Dict:
    """On the card: fwd_ms (the forward-only loss in train mode) and step_ms
    (the dense step), by CUDA events; the step's device ms by bucket from
    one trace and its device ms from a second (the two must agree); and the
    census of ``model`` on the card.  ``model`` must be the flagship's
    geometry (default: build_model)."""
    from pkr_tpu_torch.train import create_train_state, make_train_step
    from pkr_tpu_torch.train.loop import cross_entropy

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure times the card: no CUDA device was asked for")
    model = model if model is not None else build_model(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, F, T), generator=gen, device=dev)
    y = torch.randint(0, model.spk_num, (B,), generator=gen, device=dev)
    state = create_train_state(model)
    step = make_train_step(model, device=dev)
    lr = 0.05

    def fwd_only():
        model.train()
        with torch.no_grad():
            return cross_entropy(model(x, y), y)

    def one_step():
        step(state, x, y, lr)

    fwd_only()
    one_step()
    torch.cuda.synchronize()
    fwd_ms = _windows_ms(fwd_only, iters, repeats)
    step_ms = _windows_ms(one_step, iters, repeats)
    buckets, _, n_act, top = trace_buckets(one_step, profile_steps)
    _, step_device_ms, n_act2, _ = trace_buckets(one_step, profile_steps)
    rec = census(model, batch=2)
    n_params = sum(p.numel() * p.element_size() for p in model.parameters())
    return {"fwd_ms": fwd_ms, "step_ms": step_ms, "measured_ms": buckets,
            "step_device_ms": step_device_ms, "activities": [n_act, n_act2], "top": top,
            "census": rec, "n_params_bytes": n_params}


def analytic(rec: Dict, n_params_bytes: float) -> Dict:
    """The floors by bucket and the whole step's, with the ten largest
    conv passes and what bounds each."""
    items = conv_items() + rest_items(rec, n_params_bytes)
    fl = floors(items)
    convs = sorted((it for it in items if it.bucket == "convolution"), key=lambda i: -i.ms)
    return {"B": B, "F": F, "T": T, "spk": SPK,
            "conv_flops": 3.0 * B * sum(f for f, _, _ in conv_layers()),
            "train_flops": train_flops(),
            "floor_ms": fl, "floor_step_ms": sum(fl.values()),
            "conv_passes_top": [[i.name, i.ms, i.bound_by] for i in convs[:10]],
            "conv_bound_by_bytes": sum(i.bound_by == "bytes" for i in convs),
            "conv_passes": len(convs)}


def roofline(model=None, measure_card: bool = True, iters: int = 20, repeats: int = 3,
             device: DeviceLike = None) -> Dict:
    """The analytic floors and, with ``measure_card``, the card's numbers
    beside them (one dict, the JSON line's)."""
    from pkr_tpu_torch.tools.bigspk import card_line

    if not measure_card:
        rec_model = build_model("cpu")
        out = analytic(census(rec_model, batch=2),
                       sum(p.numel() * p.element_size() for p in rec_model.parameters()))
        out["card"] = "not measured"
        return out
    dev = resolve_device(device)
    m = measure(model, iters, repeats, device=dev)
    out = analytic(m["census"], m["n_params_bytes"])
    out.update({
        "fwd_ms": m["fwd_ms"], "step_ms": m["step_ms"],
        "step_over_fwd": m["step_ms"] / m["fwd_ms"],
        "measured_ms": m["measured_ms"], "step_device_ms": m["step_device_ms"],
        "activities_per_step": m["activities"],
        "measured_over_floor": {b: (m["measured_ms"][b] / out["floor_ms"][b]
                                    if out["floor_ms"][b] > 0 else None) for b in BUCKETS},
        "gap_ms": {b: m["measured_ms"][b] - out["floor_ms"][b] for b in BUCKETS},
        "conv_mfu": out["train_flops"] / (m["step_ms"] * 1e-3) / PEAK_BF16,
        "top_kernels": m["top"], "card": card_line()})
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-measure", action="store_true",
                    help="print only the analytic floors (needs no card)")
    args = ap.parse_args(argv)
    print(json.dumps(roofline(measure_card=not args.no_measure, iters=args.iters,
                              repeats=args.repeats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
