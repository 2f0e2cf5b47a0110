"""Checkpoints: save/restore with a best copy, pruning and resume, and the
two warm starts (a reference ``.pth`` state dict, or one of the port's own
checkpoints).

Port of ``pkr_tpu/train/checkpoint.py``.  The on-disk layout and its
semantics are the reference's; the storage is PyTorch's own:

- ``<path>/ckpt_<epoch>/state.pt``, or ``ckpt_<epoch>.v<k>`` when that
  epoch was saved before, written by ``torch.save`` into a temporary
  directory that is renamed into place, so a reader never sees a partial
  checkpoint.  It holds the model's ``state_dict()`` (the reference's
  names), the ``TrainState`` (momentum by parameter name, step, epoch,
  best cv top-1), the head's ``loss`` and the model's ``trunk``;
- ``<path>/latest`` holds the newest checkpoint's directory name (a legacy
  bare-epoch marker still resolves);
- ``<path>/best`` is a copy of the best epoch's directory
  (model_best.pth.tar semantics, train_resnet.py:384-385).

The model's own parameters are the training state's, so the signatures take
the model beside the ``TrainState``.

Over a process mesh every rank calls ``save_checkpoint`` with the mesh: a
class-sharded AAM weight and its momentum are gathered whole over the
model group first, so a checkpoint always holds the whole (C, D) weight
and loads the same in one process or in several (``parallel.shard_params``
cuts it again after a restore).  Only rank 0 writes the files and touches
the marker, the best copy and the pruning; a barrier then keeps the ranks
in step (``pkr_tpu``'s Orbax save has every process call it, and rank 0
alone touch the marker, best and pruning state).

The warm start from one of the port's checkpoints loads exactly the tensors
that ``pkr_tpu``'s ``load_pretrained_variables`` loads.  There the softmax
classifier is ``last/kernel`` and the AAM weight ``aam_weight``; in the port
both are ``last.weight`` of shape (C, D).  A match by name and shape alone
would copy a softmax classifier into an AAM weight, so each tensor is keyed
by its ``pkr_tpu`` path, which the head's ``loss`` and the ``trunk`` (both
saved with the checkpoint) decide: the thin ResNet's stem is a bare conv and
BatchNorm in ``pkr_tpu``, and the DenseNets carry torchvision's names.  A
checkpoint that saved no ``trunk`` holds a ResNet-family model.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from pkr_tpu_torch.train.state import TrainState

_STATE_FILE = "state.pt"
_AAM_HEADS = ("AAM", "AAM-v1")

_COMMIT_THREAD: Optional[threading.Thread] = None
_EPILOGUE_ERROR: Optional[BaseException] = None


def wait_for_checkpoints() -> None:
    """Block until an in-flight save has committed (its write, 'latest'
    marker and pruning).  Re-raises a failure of that save (disk full
    mid-best-copy, ...) — otherwise a failed marker write would be
    invisible and resume would silently restart from an older epoch."""
    global _COMMIT_THREAD, _EPILOGUE_ERROR
    if _COMMIT_THREAD is not None:
        _COMMIT_THREAD.join()
        _COMMIT_THREAD = None
    if _EPILOGUE_ERROR is not None:
        err, _EPILOGUE_ERROR = _EPILOGUE_ERROR, None
        raise err


def _parse_ckpt_name(d: str) -> Optional[Tuple[int, int]]:
    """'ckpt_<epoch>[.v<k>]' → (epoch, k) for ordering, else None."""
    if not d.startswith("ckpt_"):
        return None
    base, _, ver = d[5:].partition(".v")
    if not base.isdigit() or (ver and not ver.isdigit()):
        return None
    return int(base), int(ver) if ver else 0


def _resolve_target(path: str, which: str) -> Optional[str]:
    """'latest' → the marker's directory; 'best' → best; else ckpt_<which>.

    The marker stores the checkpoint DIRECTORY NAME (legacy markers with a
    bare epoch number still resolve)."""
    if which == "latest":
        marker = os.path.join(path, "latest")
        if not os.path.exists(marker):
            return None
        name = open(marker).read().strip()
        if name.isdigit():  # legacy marker format
            name = f"ckpt_{name}"
        return os.path.join(path, name)
    if which == "best":
        return os.path.join(path, "best")
    # explicit epoch: resolve the NEWEST version of that epoch (step-saves
    # create ckpt_<e>.v<k>, and pruning may have removed the plain dir)
    try:
        entries = [(key, d) for d in os.listdir(path)
                   if (key := _parse_ckpt_name(d)) is not None
                   and key[0] == int(which)]
    except (OSError, ValueError):
        entries = []
    if entries:
        return os.path.join(path, max(entries)[1])
    return os.path.join(path, f"ckpt_{which}")


def _host_copy(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _whole_tensors(model: torch.nn.Module, state: TrainState, mesh
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(state dict, momentum) with a class-sharded AAM weight and its
    momentum gathered whole over the mesh's model group (collective: every
    rank of the group calls it)."""
    from pkr_tpu_torch.parallel.mesh import gather_rows, weight_is_sharded

    sd, mom = model.state_dict(), dict(state.momentum)
    if mesh is not None and weight_is_sharded(model):
        sd["last.weight"] = gather_rows(sd["last.weight"], mesh, model.spk_num)
        mom["last.weight"] = gather_rows(mom["last.weight"], mesh, model.spk_num)
    return sd, mom


def save_checkpoint(path: str, model: torch.nn.Module, state: TrainState,
                    is_best: bool = False, keep_last: int = 0,
                    sync: bool = False, mesh=None) -> None:
    """Save to <path>/ckpt_<epoch>; copy to <path>/best when is_best.
    keep_last > 0 prunes older ckpt_* dirs, retaining the newest N (plus
    'best').

    The model and the state are copied to host memory before this call
    returns; the write, the 'latest' marker and the pruning then run on a
    thread, strictly in that order, so the disk write overlaps the next
    training steps.  At most one save is in flight: a new save (or a
    restore) first waits for the previous one.  A committed checkpoint is
    never deleted before its replacement commits — a re-save of the same
    epoch (mid-epoch step-saves, a resumed epoch) goes to a versioned
    'ckpt_<e>.v<k>' dir, so a failure at any point leaves the marker
    pointing at an intact checkpoint.  is_best waits (the best copy needs
    the committed files); sync=True waits too.

    mesh: every rank calls it; the whole weight is gathered, rank 0 alone
    writes, and every rank leaves through a barrier (see the module's
    docstring)."""
    global _COMMIT_THREAD
    from pkr_tpu_torch.parallel.distributed import barrier, process_index

    sd, momentum = _whole_tensors(model, state, mesh)
    if process_index() != 0:
        barrier("save_checkpoint")
        return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    wait_for_checkpoints()  # at most one save (+epilogue) in flight
    epoch = int(state.epoch)
    name = f"ckpt_{epoch}"
    if os.path.exists(os.path.join(path, name)):
        k = 1
        while os.path.exists(os.path.join(path, f"ckpt_{epoch}.v{k}")):
            k += 1
        name = f"ckpt_{epoch}.v{k}"
    target = os.path.join(path, name)
    payload = {"model": _host_copy(sd), "momentum": _host_copy(momentum),
               "step": int(state.step), "epoch": epoch,
               "best_acc1": float(state.best_acc1), "loss": model.loss,
               "trunk": model.trunk}

    def commit():
        global _EPILOGUE_ERROR
        try:
            tmp = os.path.join(path, f".{name}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _STATE_FILE))
            os.replace(tmp, target)
            with open(os.path.join(path, "latest"), "w") as f:
                f.write(name)
            if is_best:
                best = os.path.join(path, "best")
                if os.path.exists(best):
                    shutil.rmtree(best)
                shutil.copytree(target, best)
            if keep_last > 0:
                entries = [(key, d) for d in os.listdir(path)
                           if (key := _parse_ckpt_name(d)) is not None]
                for _, old in sorted(entries, reverse=True)[keep_last:]:
                    if old != name:  # never the just-committed target
                        shutil.rmtree(os.path.join(path, old), ignore_errors=True)
        except Exception as exc:  # surfaced by the next wait_for_checkpoints
            _EPILOGUE_ERROR = exc

    if is_best or sync:
        commit()
        wait_for_checkpoints()  # re-raises a failure of this save
    else:
        _COMMIT_THREAD = threading.Thread(target=commit, daemon=True)
        _COMMIT_THREAD.start()
    barrier("save_checkpoint")


def _load(target: str) -> Dict[str, Any]:
    return torch.load(os.path.join(target, _STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       state: Optional[TrainState] = None,
                       which: str = "latest") -> Optional[TrainState]:
    """Restore 'latest', 'best', or an explicit epoch number into ``model``
    (strictly, by name) and return its ``TrainState`` on the model's
    device, each momentum in its parameter's layout; None where the target
    does not exist.  ``state``, when given, is the template whose momentum
    names the checkpoint must have.  The
    checkpoint's AAM weight is whole: restore into a whole model, then
    ``parallel.shard_params(model, mesh, state)`` cuts both to a rank's
    rows."""
    wait_for_checkpoints()  # an in-flight save may be the target
    target = _resolve_target(os.path.abspath(path), which)
    if target is None or not os.path.exists(target):
        return None
    ck = _load(target)
    if state is not None and sorted(state.momentum) != sorted(ck["momentum"]):
        raise ValueError(f"{target}: its momentum does not match the train state's "
                         "parameters")
    model.load_state_dict(ck["model"], strict=True)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    # each momentum in its parameter's device and layout (models/layout.py)
    return TrainState({k: torch.empty_like(params[k]).copy_(v) for k, v in ck["momentum"].items()},
                      torch.tensor(ck["step"], dtype=torch.int64, device=dev),
                      int(ck["epoch"]), float(ck["best_acc1"]))


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------


def _densenet_key(parts: List[str]) -> Optional[Tuple[str, ...]]:
    """torchvision's DenseNet names after ``res.features`` → ``pkr_tpu``'s
    module path under ``_trunk``, with the leaf's module kind ('conv' or
    'norm') last; None for other names."""
    mod = parts[0]
    if mod in ("conv0", "norm0", "norm5"):
        kind = mod[:4]
        path = {"conv0": ("stem",), "norm0": ("BatchNorm_0",),
                "norm5": ("final_norm",)}[mod]
        return path + (kind,)
    if mod.startswith("transition") and parts[1] in ("norm", "conv"):
        sub = "BatchNorm_0" if parts[1] == "norm" else "Conv_0"
        return (mod, sub, parts[1])
    if mod.startswith("denseblock") and parts[1].startswith("denselayer"):
        kind, k = parts[2][:4], int(parts[2][4:])
        if kind in ("norm", "conv") and k in (1, 2):
            sub = f"{'BatchNorm' if kind == 'norm' else 'Conv'}_{k - 1}"
            return (f"block{int(mod[10:])}_layer{int(parts[1][10:])}", sub, kind)
    return None


def _reference_key(name: str, loss: str, trunk: str) -> Optional[Tuple[str, ...]]:
    """A state-dict name → its ``pkr_tpu`` variable path (collection, module
    path..., leaf), or None for names ``pkr_tpu`` has no variable for
    (``num_batches_tracked``, unknown modules).  ``last.weight`` is the
    softmax head's ``last/kernel`` and the AAM heads' ``aam_weight``.

    Reference naming (model.py): res.conv1/res.bn1 stem; res.layerL.J.convK
    / .bnK / .downsample.{0,1} / .se.fc.{0,2}; fc1; bn1 (head); last.
    ``pkr_tpu``'s: _trunk/stem/... (the thin trunk: _trunk/stem/kernel and
    _trunk/BatchNorm_0), _trunk/layer{L}_{J}/ConvBN_{K-1}/... and
    .../SEGate_0/Dense_{0,1}, fc1, bn1, last or aam_weight.  A DenseNet's
    torchvision names (res.features...) map as ``convert`` maps them back."""
    parts = name.split(".")
    if parts[0] == "module":
        parts = parts[1:]

    def bn_leaf(leaf):
        return {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}.get(leaf)

    def bn(mod, leaf):
        m = bn_leaf(leaf)
        return None if m is None else (m[0],) + mod + (m[1],)

    thin = trunk == "thin_resnet34"
    try:
        if parts[0] == "res":
            if parts[1] == "features":
                mod = _densenet_key(parts[2:])
                if mod is None:
                    return None
                *mod, kind = mod
                leaf = parts[-1]
                if kind == "conv":
                    return (("params", "_trunk") + tuple(mod) + ("kernel",)
                            if leaf == "weight" else None)
                return bn(("_trunk",) + tuple(mod), leaf)
            if parts[1] == "conv1" and parts[2] == "weight":
                return ("params", "_trunk", "stem") + (("kernel",) if thin
                                                       else ("Conv_0", "kernel"))
            if parts[1] == "bn1":
                return bn(("_trunk", "BatchNorm_0") if thin
                          else ("_trunk", "stem", "BatchNorm_0"), parts[2])
            if parts[1].startswith("layer"):
                block = ("_trunk", f"layer{int(parts[1][5:])}_{int(parts[2])}")
                sub = parts[3]
                if sub in ("conv1", "conv2", "conv3") and parts[4] == "weight":
                    return ("params",) + block + (f"ConvBN_{int(sub[-1]) - 1}", "Conv_0",
                                                  "kernel")
                if sub in ("bn1", "bn2", "bn3"):
                    return bn(block + (f"ConvBN_{int(sub[-1]) - 1}", "BatchNorm_0"),
                              parts[4])
                if sub == "downsample":
                    if parts[4] == "0" and parts[5] == "weight":
                        return ("params",) + block + ("downsample", "Conv_0", "kernel")
                    if parts[4] == "1":
                        return bn(block + ("downsample", "BatchNorm_0"), parts[5])
                if sub == "se" and parts[4] == "fc" and parts[6] == "weight":
                    dense = {"0": "Dense_0", "2": "Dense_1"}.get(parts[5])
                    if dense:
                        return ("params",) + block + ("SEGate_0", dense, "kernel")
            return None
        if parts[0] == "fc1":
            return ("params", "fc1", {"weight": "kernel", "bias": "bias"}[parts[1]])
        if parts[0] == "bn1":
            return bn(("bn1",), parts[1])
        if parts[0] == "last" and parts[1] == "weight":
            return (("params", "aam_weight") if loss in _AAM_HEADS
                    else ("params", "last", "kernel"))
        if parts[0] == "last" and parts[1] == "bias":
            return ("params", "last", "bias")
    except (KeyError, ValueError, IndexError):
        pass  # malformed/unknown key shapes: skip, don't abort
    return None


def import_torch_checkpoint(state_dict: Mapping[str, Any], model: torch.nn.Module,
                            verbose: bool = True) -> List[str]:
    """Copy reference-model weights (a ``.pth`` state dict; values torch
    tensors or numpy) into ``model`` in place, name-tolerantly: unknown
    names and shape mismatches are skipped with a message (loadParameters
    semantics, model.py:415-432), ``num_batches_tracked`` silently.  The
    reference's names are the port's, a leading ``module.`` aside.  Returns
    the names loaded."""
    own = model.state_dict()
    loaded = []
    for name, value in state_dict.items():
        key = name[len("module."):] if name.startswith("module.") else name
        if _reference_key(key, model.loss, model.trunk) is None or key not in own:
            if verbose and not name.endswith("num_batches_tracked"):
                print(f"{name} is not in the model.")
            continue
        arr = torch.as_tensor(value.detach().cpu() if hasattr(value, "detach") else value)
        tgt = own[key]
        if tuple(tgt.shape) != tuple(arr.shape):
            if verbose:
                print(f"Wrong parameter length: {name}, model: {tuple(tgt.shape)}, "
                      f"loaded: {tuple(arr.shape)}")
            continue
        with torch.no_grad():
            tgt.copy_(arr.to(tgt.dtype))
        loaded.append(key)
    if verbose:
        print(f"imported {len(loaded)}/{len(state_dict)} tensors")
    return loaded


def _tree(state_dict: Mapping[str, torch.Tensor], loss: str, trunk: str
          ) -> Dict[str, Any]:
    """state dict → nested dict by ``pkr_tpu`` variable path, with
    (name, tensor) leaves."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        path = _reference_key(name, loss, trunk)
        if path is None:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = (name, t)
    return tree


def load_pretrained(path: str, model: torch.nn.Module, which: str = "best",
                    verbose: bool = True) -> List[str]:
    """Name-tolerant warm start from one of the port's checkpoints (the
    loadParameters role for cross-head init, e.g. AAM from a softmax model —
    run_aam_v2.sh:82): variables whose ``pkr_tpu`` path exists in ``model``
    with a matching shape are copied in place; everything else is skipped
    with a message, a missing subtree once, as ``pkr_tpu`` does.  Returns
    the names loaded; ``model`` is left alone where no checkpoint
    resolves.

    A strict ``restore_checkpoint`` would reject the head mismatch (the
    softmax head has bn1/last, the AAM head its margin weight)."""
    wait_for_checkpoints()
    path = os.path.abspath(path)
    if which == "latest":
        target = _resolve_target(path, "latest")
        if target is None:
            return []
    else:
        target = os.path.join(path, which)  # 'best' or an arbitrary name
        if not os.path.exists(target):
            target = _resolve_target(path, which)  # epoch-number resolution
        if target is None or not os.path.exists(target):
            target = _resolve_target(path, "latest")  # fall back to latest
            if target is None:
                return []
    ck = _load(target)
    # a checkpoint that saved no trunk holds a ResNet-family model
    return warm_start(ck["model"], ck["loss"], ck.get("trunk", "resnet34"), model,
                      verbose=verbose)


def warm_start(state_dict: Mapping[str, torch.Tensor], loss: str, trunk: str,
               model: torch.nn.Module, verbose: bool = True) -> List[str]:
    """Copy a ``loss``/``trunk`` model's state dict into ``model`` in place
    by ``pkr_tpu`` variable path (``_reference_key``), the rule of
    ``pkr_tpu``'s name-and-shape warm start: a variable whose path exists in
    ``model`` with a matching shape is copied; everything else is skipped
    with a message, a missing subtree once.  So a softmax classifier
    (``last/kernel``) never lands in an AAM weight (``aam_weight``), though
    both are ``last.weight`` of one shape here.  Returns the names loaded."""
    src = _tree(state_dict, loss, trunk)
    dst = _tree(model.state_dict(), model.loss, model.trunk)
    loaded: List[str] = []
    n_skipped = 0

    def walk(s, d, prefix):
        nonlocal n_skipped
        for k, v in s.items():
            where = "/".join(prefix + (k,))
            if k not in d:
                n_skipped += 1
                if verbose:
                    print(f"{where} is not in the model.")
            elif isinstance(v, dict):
                walk(v, d[k], prefix + (k,))
            else:
                (_, arr), (dst_name, tgt) = v, d[k]
                if arr.shape == tgt.shape:
                    with torch.no_grad():
                        tgt.copy_(arr.to(tgt.dtype))
                    loaded.append(dst_name)
                else:
                    n_skipped += 1
                    if verbose:
                        print(f"Wrong parameter length: {where}, "
                              f"model: {tuple(tgt.shape)}, loaded: {tuple(arr.shape)}")

    for coll in ("params", "batch_stats"):
        if coll in dst and coll in src:
            walk(src[coll], dst[coll], (coll,))
    if verbose:
        print(f"warm start: loaded {len(loaded)} tensors, skipped {n_skipped}")
    return loaded
