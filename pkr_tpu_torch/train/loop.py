"""The train and eval steps and the epoch loop.

Port of ``pkr_tpu/train/loop.py``: ``cross_entropy``, ``topk_correct``
(top-k as accuracy.py:4-17 of the reference), ``make_train_step`` with the
dense head or the flash head, ``make_eval_step`` and ``train_and_validate``,
each on one process or over a process mesh (``mesh=``,
``parallel/mesh.py``).

The model holds the parameters and the BatchNorm statistics and the
``TrainState`` the momentum, so a train step updates both in place and
returns the same state.  Each step sets the model's mode itself: the train
step puts it in train mode (batch statistics), the eval step in eval mode
(running statistics), so cv never runs with batch statistics whichever
step ran last.

Over a mesh each rank takes its share of the global batch (ranks of one
data row the same share), and the step computes what ``pkr_tpu``'s pjit
step computes over the whole batch: BatchNorm normalizes with the global
batch's statistics (``models/resnet.py``), the loss and the metrics are
global means, and the gradients are reduced explicitly, one flat
all_reduce over the data group before the SGD update.  (``torch.autograd.grad``
never runs ``AccumulateGrad``, so ``DistributedDataParallel``'s reducer
hooks would not fire.)  The flash head over a mesh reduces its weight's
gradient itself (``ops/flash_aam.py``: ``make_flash_aam_sharded``), so the
flat all_reduce leaves it out.  The NaN guard decides on the global loss,
so every rank commits or none does.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from pkr_tpu_torch.device import DeviceLike, as_device_tensor, full_f32, resolve_device
from pkr_tpu_torch.models.layout import use_device_layout
from pkr_tpu_torch.models.resnet import commit_batch_stats, set_batch_norm_group
from pkr_tpu_torch.ops.flash_aam import flash_aam_loss_acc, make_flash_aam_sharded
from pkr_tpu_torch.parallel.mesh import weight_is_sharded
from pkr_tpu_torch.train.state import TrainState, cosine_epoch_lr, sgd_step
from pkr_tpu_torch.utils import trace
from pkr_tpu_torch.utils.logging import AverageMeter, ProgressLogger


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.to(torch.int64)[:, None]))


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Count of examples whose label is in the top-k logits."""
    _, idx = torch.topk(logits, min(k, logits.shape[-1]), dim=-1)
    return torch.sum(torch.any(idx == labels.to(torch.int64)[:, None], dim=1)
                     .to(torch.float32))


def _check_flash(model, flash_aam: bool) -> None:
    if flash_aam and model.loss not in ("AAM", "AAM-v1"):
        raise ValueError(f"flash_aam needs an AAM-family head, got {model.loss!r}")
    if weight_is_sharded(model) and not flash_aam:
        raise ValueError("a class-sharded AAM weight needs the flash head "
                         "(flash_aam=True); the dense head takes the whole weight")


def _flash_head(model, mesh):
    """(emb, weight, labels) → (loss, top-1, top-5) of ``model``'s flash
    head: over a mesh, in the regime its weight is laid out in
    (``parallel.shard_params``), with global means."""
    if mesh is None:
        return lambda e, w, y: flash_aam_loss_acc(e, w, y, model.m, model.s)
    return make_flash_aam_sharded(mesh, model.spk_num, model.m, model.s,
                                  weight_sharded=weight_is_sharded(model), with_acc=True)


def _data_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the mesh's data group, in place (the identity
    without a mesh or on a one-rank axis)."""
    if mesh is not None and mesh.data_group is not None:
        dist.all_reduce(t, group=mesh.data_group)
    return t


def _reduce_grads(grads, mesh):
    """The gradients summed over the data group in one flat all_reduce.
    Each is flattened in the order its elements lie in memory and comes
    back with its own strides, so a channels_last gradient stays in its
    parameter's and its momentum's layout (``models/layout.py``)."""
    if not grads or mesh is None or mesh.data_group is None:
        return grads
    grads = [g if g.is_contiguous() or g.is_contiguous(memory_format=torch.channels_last)
             else g.contiguous() for g in grads]  # dense: one block of memory each
    flat = _data_sum(torch.cat([g.as_strided((g.numel(),), (1,)) for g in grads]), mesh)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].as_strided(g.shape, g.stride()))
        offset += g.numel()
    return out


def make_train_step(model, momentum: float = 0.9, weight_decay: float = 5e-4,
                    flash_aam: bool = False, device: DeviceLike = None, mesh=None
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, feats (B, F, T), labels (B,), lr) →
    (state, {'loss', 'acc1', 'acc5'}), the metrics as f32 scalars on the
    device.  The model is moved to ``device`` and takes its trunk layout
    (``models/layout.py``); ``state`` must be on it too, each momentum in
    its parameter's layout (``create_train_state``, ``TrainState.to``).

    flash_aam (AAM and AAM-v1 heads) routes the head through the flash
    loss (ops/flash_aam.py): the (B, n_spk) logits never exist, top-1 comes
    from the forward kernel's online max and top-5 from its online
    target-rank count, and the backward kernel gives the head's gradients.

    NaN guard: a non-finite loss commits nothing (parameters, momentum and
    BatchNorm running statistics keep their values) while the step counter
    still advances.  The guard is decided on the device, so a step never
    waits for the host.

    mesh (``parallel.make_mesh``): ``feats`` and ``labels`` are this rank's
    share of the global batch, and the step is the global batch's (see the
    module's docstring); its metrics are global.  The model's BatchNorms
    take the mesh's data group.  A class-sharded AAM weight
    (``parallel.shard_params``) needs the flash head.

    While the tracer is on (``utils/trace.py``) a step is the spans
    ``step.forward``, ``step.backward`` and ``step.update``, the last with
    ``step.bn_commit`` inside."""
    _check_flash(model, flash_aam)
    dev = resolve_device(device)
    use_device_layout(model.to(dev))
    names, params = zip(*model.named_parameters())
    n_data = 1 if mesh is None else mesh.n_data
    if mesh is not None:
        set_batch_norm_group(model, mesh.data_group)
    flash_fn = _flash_head(model, mesh) if flash_aam else None
    # the gradients the step all-reduces: all but a mesh flash head's weight,
    # whose backward sums its gradient over the data group itself
    reduced = [i for i, n in enumerate(names)
               if not (flash_aam and mesh is not None and n == "last.weight")]

    def train_step(state: TrainState, feats, labels, lr: float
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with trace.span("step.forward"):
            model.train()
            feats = as_device_tensor(feats, dev, torch.float32)
            labels = as_device_tensor(labels, dev, torch.int64)
            if flash_aam:  # over a mesh: the global means
                emb = model.head_input(feats)
                loss, acc1, acc5 = flash_fn(emb, model.last.weight, labels)
                objective = loss
            else:
                logits = model(feats, labels)
                objective = cross_entropy(logits, labels) / n_data  # its share of the mean
                with torch.no_grad():
                    metrics = torch.stack([objective, topk_correct(logits, labels, 1),
                                           topk_correct(logits, labels, 5)])
                    metrics[1:] /= labels.shape[0] * n_data
                    loss, acc1, acc5 = _data_sum(metrics, mesh).unbind()
        with trace.span("step.backward"), full_f32():  # f32 convs and matmuls too
            grads = list(torch.autograd.grad(objective, params))
        with trace.span("step.update"), torch.no_grad():
            for i, g in zip(reduced, _reduce_grads([grads[i] for i in reduced], mesh)):
                grads[i] = g
            ok = torch.isfinite(loss)
            with trace.span("step.bn_commit"):
                commit_batch_stats(model, ok)
            sgd_step(params, grads, [state.momentum[n] for n in names], lr, ok,
                     momentum, weight_decay)
            state.step += 1
        return state, {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}

    return train_step


def make_eval_step(model, flash_aam: bool = False, device: DeviceLike = None, mesh=None
                   ) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns eval_step(feats (B, F, T), labels (B,)) → {'loss': CE·B,
    'n1': top-1 count, 'n5': top-5 count, 'n': B}, as f32 scalars.

    flash_aam routes the loss through the flash head (ops/flash_aam.py): the
    (B, n_spk) logits never exist, top-1 comes from the kernel's online max
    and top-5 from its online target-rank count.  The model is moved to
    ``device`` and takes its trunk layout (``models/layout.py``); every
    call puts it in eval mode.

    mesh: ``feats`` and ``labels`` are this rank's share of a global batch,
    and the sums are the global batch's (every rank of the data group must
    call it for the same number of batches)."""
    _check_flash(model, flash_aam)
    dev = resolve_device(device)
    use_device_layout(model.to(dev))
    n_data = 1 if mesh is None else mesh.n_data
    flash_fn = _flash_head(model, mesh) if flash_aam else None

    @torch.no_grad()
    def eval_step(feats, labels) -> Dict[str, torch.Tensor]:
        model.eval()
        feats = as_device_tensor(feats, dev, torch.float32)
        labels = as_device_tensor(labels, dev, torch.int64)
        bsz = labels.shape[0] * n_data
        n = torch.tensor(float(bsz), device=dev)
        if flash_aam:  # over a mesh: the global means
            emb = model.head_input(feats)
            loss, acc, acc5 = flash_fn(emb, model.last.weight, labels)
            return {"loss": loss * bsz, "n1": acc * bsz, "n5": acc5 * bsz, "n": n}
        logits = model(feats, labels)
        sums = _data_sum(torch.stack([cross_entropy(logits, labels) * labels.shape[0],
                                      topk_correct(logits, labels, 1),
                                      topk_correct(logits, labels, 5)]), mesh)
        return {"loss": sums[0], "n1": sums[1], "n5": sums[2], "n": n}

    return eval_step


def train_and_validate(model, state: TrainState, train_loader, cv_loader,
                       epochs: int, lr0: float, lr_final: float = 0.0,
                       momentum: float = 0.9, weight_decay: float = 5e-4,
                       start_epoch: int = 0, print_freq: int = 100,
                       on_epoch_end: Optional[Callable] = None,
                       logger: Optional[ProgressLogger] = None,
                       flash_aam: bool = False, save_every_steps: int = 0,
                       on_step_save: Optional[Callable] = None,
                       profile_dir: Optional[str] = None, profile_steps: int = 10,
                       device: DeviceLike = None, mesh=None) -> TrainState:
    """The epoch loop (train → validate → best-tracking on cv top-1).

    Loaders are duck-typed: ``loader.epoch(epoch)`` yields (feats, labels).
    The learning rate follows ``cosine_epoch_lr`` once per epoch.
    ``on_step_save(state)`` runs every ``save_every_steps`` steps and
    ``on_epoch_end(state, epoch, {'acc1', 'acc5', 'loss', 'is_best'})``
    after each cv pass.  profile_dir traces ``profile_steps`` steady steps
    of the first epoch (steps 5 .. 5 + n) with ``torch.profiler``.

    mesh: the loaders yield this rank's share of each global batch (the
    same number of batches on every rank), and the steps run over the mesh;
    the cv metrics are the global batch's on every rank."""
    dev = resolve_device(device)
    log = logger or ProgressLogger()
    prof = contextlib.ExitStack()
    prof_window = (5, 5 + profile_steps)
    train_step = make_train_step(model, momentum, weight_decay, flash_aam, dev, mesh)
    eval_step = make_eval_step(model, flash_aam, dev, mesh)
    schedule = cosine_epoch_lr(lr0, epochs, lr_final)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # host-side mirror of state.step: reading the device counter every step
    # would wait for the step just queued
    host_step = int(state.step)
    for epoch in range(start_epoch, epochs):
        lr = schedule(epoch)
        meters = {k: AverageMeter(k) for k in ("loss", "acc1", "acc5", "time")}
        t0 = time.time()
        for i, (feats, labels) in enumerate(train_loader.epoch(epoch)):
            if profile_dir and epoch == start_epoch and i == prof_window[0]:
                prof.enter_context(trace.profile_trace(profile_dir))
            state, metrics = train_step(state, feats, labels, lr)
            host_step += 1
            if profile_dir and epoch == start_epoch and i + 1 == prof_window[1]:
                sync()
                prof.close()
            if save_every_steps and on_step_save and host_step % save_every_steps == 0:
                on_step_save(state)
            if (i + 1) % print_freq == 0:
                sync()
                dt = time.time() - t0
                meters["time"].update(dt / print_freq, print_freq)
                for k in ("loss", "acc1", "acc5"):
                    meters[k].update(float(metrics[k]))
                log.log(f"epoch {epoch} [{i + 1}] lr={lr:.5f} " +
                        " ".join(str(m) for m in meters.values()),
                        epoch=epoch, step=i + 1, lr=lr,
                        loss=meters["loss"].avg, acc1=meters["acc1"].avg,
                        step_time=meters["time"].avg)
                t0 = time.time()
        prof.close()  # short epochs: stop an unclosed trace window
        host_step = int(state.step)
        totals = {"loss": 0.0, "n1": 0.0, "n5": 0.0, "n": 0.0}
        for feats, labels in cv_loader.epoch(epoch):
            out = eval_step(feats, labels)
            for k in totals:
                totals[k] += float(out[k])
        acc1 = totals["n1"] / max(totals["n"], 1.0)
        acc5 = totals["n5"] / max(totals["n"], 1.0)
        cv_loss = totals["loss"] / max(totals["n"], 1.0)
        log.log(f"epoch {epoch} CV: loss={cv_loss:.4f} acc1={acc1:.4f} acc5={acc5:.4f}",
                epoch=epoch, loss=cv_loss, acc1=acc1, acc5=acc5)
        # a non-finite metric must not poison the running max
        metric = acc1 if math.isfinite(acc1) else -math.inf
        is_best = metric > state.best_acc1
        state.epoch = epoch + 1
        state.best_acc1 = max(state.best_acc1, metric)
        if on_epoch_end is not None:
            on_epoch_end(state, epoch, {"acc1": acc1, "acc5": acc5, "loss": cv_loss,
                                        "is_best": is_best})
    return state
