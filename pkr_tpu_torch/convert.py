"""Flax variables of ``pkr_tpu`` → the port's state dict.

The inverse of ``pkr_tpu/train/checkpoint.py``'s torch→flax importer, for
the speaker model with any trunk of the zoo.  ``variables`` is the JAX
package's ``{'params': ..., 'batch_stats': ...}`` tree with numpy (or
array-like) leaves; nothing of JAX is imported.  A DenseNet trunk (its tree
has ``_trunk/final_norm``) maps onto torchvision's names
(``res.features...``), every other trunk onto the reference's ResNet names;
the thin ResNet's bare stem conv and ``BatchNorm_0`` are its
``res.conv1``/``res.bn1``.

- conv kernels: HWIO → OIHW;
- Dense kernels: (in, out) → (out, in);
- BatchNorm scale/bias/mean/var → weight/bias/running_mean/running_var
  (+ num_batches_tracked = 0, so ``load_state_dict`` can be strict);
- ``aam_weight`` → ``last.weight`` as it is, (spk_num, emb_dim).

:func:`train_state_from_flax` also carries a ``pkr_tpu`` ``TrainState``
across mid-training: the optax momentum trace has the layout of the params,
so it moves by the same names and transposes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from pkr_tpu_torch.train.state import TrainState

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _resnet_name(path: Tuple[str, ...]) -> str:
    """flax path under ``_trunk`` of a ResNet-family trunk → module name."""
    block = path[0]
    if block == "stem":  # ConvBN stem/{Conv_0,BatchNorm_0}; the thin trunk's bare stem
        return "res." + ("conv1" if path[1:] in ((), ("Conv_0",)) else "bn1")
    if block == "BatchNorm_0":  # the thin trunk's stem BatchNorm
        return "res.bn1"
    layer, j = block[len("layer"):].split("_")
    prefix = f"res.layer{layer}.{j}."
    if path[1] == "downsample":
        return prefix + ("downsample.0" if path[2] == "Conv_0" else "downsample.1")
    if path[1] == "SEGate_0":  # Dense_0 → fc.0, Dense_1 → fc.2
        return prefix + f"se.fc.{2 * int(path[2][len('Dense_'):])}"
    k = int(path[1][len("ConvBN_"):]) + 1  # ConvBN_0/Conv_0 → conv1, .../BatchNorm_0 → bn1
    return prefix + (f"conv{k}" if path[2] == "Conv_0" else f"bn{k}")


def _densenet_name(path: Tuple[str, ...]) -> str:
    """flax path under ``_trunk`` of a DenseNet trunk → torchvision's name."""
    mod = path[0]
    if mod == "stem":
        return "res.features.conv0"
    if mod == "BatchNorm_0":
        return "res.features.norm0"
    if mod == "final_norm":
        return "res.features.norm5"
    if mod.startswith("transition"):
        return f"res.features.{mod}." + ("norm" if path[1] == "BatchNorm_0" else "conv")
    block, layer = mod[len("block"):].split("_layer")
    kind, k = path[1].split("_")  # BatchNorm_{0,1} → norm{1,2}, Conv_{0,1} → conv{1,2}
    return (f"res.features.denseblock{block}.denselayer{layer}."
            f"{'norm' if kind == 'BatchNorm' else 'conv'}{int(k) + 1}")


def _module_name(path: Tuple[str, ...], densenet: bool) -> str:
    """flax module path (without the leaf) → the port's module name."""
    if path[0] != "_trunk":
        return ".".join(path[:1])  # fc1, bn1, last
    return (_densenet_name if densenet else _resnet_name)(path[1:])


def _is_bn(mod: Tuple[str, ...]) -> bool:
    return mod[-1].startswith("BatchNorm") or mod[-1] == "final_norm" or mod == ("bn1",)


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Returns the port's ``SpeakerModel`` state dict for flax ``variables``."""
    out: Dict[str, torch.Tensor] = {}
    densenet = "final_norm" in variables.get("params", {}).get("_trunk", {})
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(coll, {})):
            arr = np.asarray(arr, dtype=np.float32)
            if path == ("aam_weight",):
                out["last.weight"] = torch.tensor(arr)
                continue
            *mod, leaf = path
            mod = tuple(mod)
            name = _module_name(mod, densenet)
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                leaf = "weight"
            elif _is_bn(mod):
                leaf = _BN_LEAF[leaf]
                bn_count = name + ".num_batches_tracked"
                out.setdefault(bn_count, torch.zeros((), dtype=torch.int64))
            out[f"{name}.{leaf}"] = torch.tensor(arr)  # a contiguous copy
    return out


def _momentum_trace(opt_state: Any) -> Optional[Mapping[str, Any]]:
    """The params-shaped ``trace`` of optax's TraceState, wherever it sits in
    the (named) tuples and dicts of an optax state."""
    trace = getattr(opt_state, "trace", None)
    if isinstance(trace, Mapping):
        return trace
    children = (opt_state.values() if isinstance(opt_state, Mapping)
                else opt_state if isinstance(opt_state, (tuple, list)) else ())
    for child in children:
        found = _momentum_trace(child)
        if found is not None:
            return found
    return None


def train_state_from_flax(state: Any) -> Tuple[Dict[str, torch.Tensor], TrainState]:
    """A ``pkr_tpu`` ``TrainState`` (params, batch_stats, opt_state with the
    optax momentum trace, step, epoch, best_acc1; numpy or array-like
    leaves) → (the port's model state dict, its ``TrainState`` on the CPU).
    Load the first with ``load_state_dict(strict=True)`` and move the second
    with ``.to(device)``."""
    sd = state_dict_from_flax({"params": state.params,
                               "batch_stats": state.batch_stats})
    trace = _momentum_trace(state.opt_state)
    if trace is None:
        raise ValueError("opt_state holds no optax momentum trace")
    momentum = {k: v for k, v in state_dict_from_flax({"params": trace}).items()
                if not k.endswith(".num_batches_tracked")}
    return sd, TrainState(momentum, torch.tensor(int(np.asarray(state.step)), dtype=torch.int64),
                          int(np.asarray(state.epoch)), float(np.asarray(state.best_acc1)))
