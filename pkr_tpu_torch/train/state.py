"""Train state and optimizer.

Port of ``pkr_tpu/train/state.py``: SGD with momentum 0.9 and weight decay
5e-4 added to the gradient before the momentum trace, on every parameter
(BatchNorm and the AAM weight included), and a cosine learning rate stepped
once per epoch from lr0 down to lr_final.

The parameters and the BatchNorm statistics live in the model.  The state
holds what the optimizer and the epoch loop add: one momentum buffer per
parameter (by the parameter's name), the step counter (a tensor on the
device, so that a step needs no host sync), the epoch and the best cv top-1.

The update is written with ``torch._foreach_*`` ops and ``torch.where``
rather than ``torch.optim.SGD``.  The arithmetic is the same (SGD with
dampening 0 and no Nesterov, which is also optax's ``add_decayed_weights →
sgd(momentum)``), but the train step's NaN guard decides on the device
whether a step commits, and ``torch.optim.SGD`` cannot make its update
conditional on a device tensor.  Buffers and parameters are updated in
place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence

import torch

from pkr_tpu_torch.models import layout


def cosine_epoch_lr(lr0: float, epochs: int, lr_final: float = 0.0
                    ) -> Callable[[int], float]:
    """eta_min + (lr0 - eta_min) * (1 + cos(pi * epoch / T)) / 2."""

    def schedule(epoch: int) -> float:
        frac = min(max(epoch / epochs, 0.0), 1.0)
        return lr_final + (lr0 - lr_final) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


@dataclasses.dataclass
class TrainState:
    momentum: Dict[str, torch.Tensor]  # the SGD trace of each parameter, by name
    step: torch.Tensor  # int64 scalar on the model's device
    epoch: int = 0
    best_acc1: float = 0.0

    def to(self, device) -> "TrainState":
        """The state on ``device``, a convolution's (4-D) momentum in the
        trunk layout of that device (``models/layout.py``), as the
        convolution's weight is there."""
        fmt = layout.memory_format_for(device)
        return dataclasses.replace(
            self, momentum={k: v.to(device, memory_format=fmt) if v.ndim == 4 else v.to(device)
                            for k, v in self.momentum.items()},
            step=self.step.to(device))


def create_train_state(model: torch.nn.Module) -> TrainState:
    """Zero momentum for every parameter of ``model``, on its device and in
    its layout."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState({k: torch.zeros_like(p) for k, p in params.items()},
                      torch.zeros((), dtype=torch.int64, device=dev))


@torch.no_grad()
def sgd_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             momentum_bufs: Sequence[torch.Tensor], lr: float, ok: torch.Tensor,
             momentum: float = 0.9, weight_decay: float = 5e-4) -> None:
    """t ← μ·t + (g + wd·p); p ← p − lr·t, committed only where the device
    bool ``ok`` holds."""
    trace = torch._foreach_add(list(grads), list(params), alpha=weight_decay)
    torch._foreach_add_(trace, torch._foreach_mul(list(momentum_bufs), momentum))
    new_params = torch._foreach_add(list(params), trace, alpha=-lr)
    for buf, t, p, q in zip(momentum_bufs, trace, params, new_params):
        buf.copy_(torch.where(ok, t, buf))
        p.copy_(torch.where(ok, q, p))
