"""The reference's train steps: the embedding model in float32 (TF32 off),
the blocked AAM loss, plain SGD with momentum and weight decay added to the
gradient before the momentum trace (t <- μ·t + g + wd·p; p <- p − lr·t), and
the BatchNorm running statistics folded after each step.

It follows the program's first steps on the crops it derives itself and
returns, per leaf, the numbers the comparison needs: each step's loss,
the first step's gradient norm, and after the last step the norms of the
parameters' change, of the momentum and of each running statistic's
change.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from portbench.reference import aam, resnet, strict_f32


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float32)))


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                batches: List[Tuple[torch.Tensor, torch.Tensor]], lr: float,
                momentum: float, weight_decay: float, conv: resnet.Conv = resnet.f32_conv,
                batch_rows: Optional[slice] = None, zero_grad: Iterable[str] = ()) -> dict:
    """``batches``: (crops (B, F, T) f32, labels (B,)) of each step.
    ``conv`` replaces the f32 convolution (the low-precision control);
    ``batch_rows`` trains on a part of each batch and ``zero_grad`` names
    leaves whose gradient is taken as zero (faults' readings)."""
    p = {n: t.detach().to(torch.float32).clone() for n, t in weights.items()
         if not resnet.is_stat(n)}
    stats0 = {n: t.detach().clone() for n, t in weights.items()
              if n.endswith(("running_mean", "running_var"))}
    run_stats = {n: t.clone() for n, t in stats0.items()}
    p0 = {n: t.clone() for n, t in p.items()}
    mom = {n: torch.zeros_like(t) for n, t in p.items()}
    out = {"loss": [], "acc1": [], "acc5": []}
    with strict_f32():
        for k, (x, y) in enumerate(batches):
            if batch_rows is not None:
                x, y = x[batch_rows], y[batch_rows]
            leaves = {n: t.requires_grad_() for n, t in
                      ((n, t.detach().clone()) for n, t in p.items())}
            stats: dict = {}
            emb = resnet.embed({**leaves, **run_stats}, cfg, x, True, None, stats, conv)
            loss, acc1, acc5 = aam.aam_loss_acc(emb, leaves["last.weight"], y,
                                                cfg["m"], cfg["s"])
            grads = [torch.zeros_like(g) if n in zero_grad else g for n, g in
                     zip(leaves, torch.autograd.grad(loss, list(leaves.values())))]
            with torch.no_grad():
                for (n, _), g in zip(leaves.items(), grads):
                    mom[n] = momentum * mom[n] + (g + weight_decay * p[n])
                    p[n] = p[n] - lr * mom[n]
                for name, (mean, var) in stats.items():
                    for key, stat in (("running_mean", mean), ("running_var", var)):
                        r = run_stats[f"{name}.{key}"]
                        run_stats[f"{name}.{key}"] = resnet.MOMENTUM * r + (1 - resnet.MOMENTUM) * stat
            if k == 0:
                out["grad1"] = {n: _norm(g) for (n, _), g in zip(leaves.items(), grads)}
            out["loss"].append(float(loss.detach()))
            out["acc1"].append(float(acc1))
            out["acc5"].append(float(acc5))
    out["change"] = {n: _norm(p[n] - p0[n]) for n in p}
    out["mom"] = {n: _norm(mom[n]) for n in p}
    out["bnstat"] = {n: _norm(run_stats[n] - stats0[n]) for n in stats0}
    return out
