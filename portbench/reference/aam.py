"""The additive-angular-margin (ArcFace) loss over the classes in blocks.

Cosines of the L2-normalized embeddings and class weights (norms clamped
at 1e-12); the target's cosine becomes cos(θ + m) where cos θ > cos(π − m)
and cos θ − m·sin(π − m) elsewhere (the sine from 1 − cos², clamped to
[1e-12, 1]); every logit is scaled by s; the loss is the batch mean of the
log-sum-exp less the target's logit.  No (B, C) logits are held: the
forward keeps a running log-sum-exp over blocks of classes, the backward
forms each block's logits again and its share of the gradients.
Top-1 and top-5 count the classes whose logit beats the target's.
"""

from __future__ import annotations

import math

import torch

BLOCK = 65536


def _phi(cos: torch.Tensor, m: float) -> torch.Tensor:
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, 1e-12, 1.0))
    phi = cos * math.cos(m) - sin * math.sin(m)
    return torch.where(cos > math.cos(math.pi - m), phi, cos - math.sin(math.pi - m) * m)


def _block_logits(e_hat, w_blk, labels, c0, m, s):
    cos = e_hat @ w_blk.T
    cols = torch.arange(c0, c0 + w_blk.shape[0], device=cos.device)
    is_t = labels[:, None] == cols[None, :]
    return torch.where(is_t, _phi(cos, m), cos) * s


class _BlockedAAM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e_hat, w_hat, labels, m, s):
        B, C = e_hat.shape[0], w_hat.shape[0]
        mx = torch.full((B,), -math.inf, device=e_hat.device)
        se = torch.zeros((B,), device=e_hat.device)
        zy = torch.zeros((B,), device=e_hat.device)
        for c0 in range(0, C, BLOCK):
            z = _block_logits(e_hat, w_hat[c0:c0 + BLOCK], labels, c0, m, s)
            new = torch.maximum(mx, z.max(dim=1).values)
            se = se * torch.exp(mx - new) + torch.exp(z - new[:, None]).sum(dim=1)
            mx = new
            in_blk = (labels >= c0) & (labels < c0 + z.shape[1])
            idx = torch.clamp(labels - c0, 0, z.shape[1] - 1)
            zy += torch.where(in_blk, z.gather(1, idx[:, None])[:, 0], 0.0)
        lse = mx + torch.log(se)
        beats = torch.zeros((B,), device=e_hat.device)
        for c0 in range(0, C, BLOCK):
            z = _block_logits(e_hat, w_hat[c0:c0 + BLOCK], labels, c0, m, s)
            beats += (z > zy[:, None]).sum(dim=1)
        ctx.save_for_backward(e_hat, w_hat, labels, lse)
        ctx.consts = (m, s)
        acc1, acc5 = (beats < 1).float().mean(), (beats < 5).float().mean()
        ctx.mark_non_differentiable(acc1, acc5)
        return torch.mean(lse - zy), acc1, acc5

    @staticmethod
    def backward(ctx, g, _g1, _g5):
        e_hat, w_hat, labels, lse = ctx.saved_tensors
        m, s = ctx.consts
        B = e_hat.shape[0]
        de = torch.zeros_like(e_hat)
        dw = torch.empty_like(w_hat)
        for c0 in range(0, w_hat.shape[0], BLOCK):
            with torch.enable_grad():
                e = e_hat.detach().requires_grad_()
                w = w_hat[c0:c0 + BLOCK].detach().requires_grad_()
                z = _block_logits(e, w, labels, c0, m, s)
                cols = torch.arange(c0, c0 + w.shape[0], device=z.device)
                onehot = (labels[:, None] == cols[None, :]).to(z.dtype)
                gz = (torch.exp(z - lse[:, None]) - onehot) * (g / B)
                de_b, dw_b = torch.autograd.grad(z, (e, w), gz)
            de += de_b
            dw[c0:c0 + BLOCK] = dw_b
        return de, dw, None, None, None


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def aam_loss_acc(emb: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                 m: float, s: float):
    """(mean loss, top-1, top-5) of the AAM head; differentiable in emb and
    weight."""
    return _BlockedAAM.apply(_normalize(emb), _normalize(weight), labels.to(torch.int64), m, s)
