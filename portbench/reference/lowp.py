"""The control: the reference computed one precision below what the
configuration states.  A bf16 trunk's is fp8: every convolution's operands
rounded to float8 e4m3 and the gradients that reach it to e5m2, each
tensor scaled by its largest magnitude (per-tensor scaling), accumulated
in f32; a float32 stage's is TF32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _q(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    fmax = torch.finfo(dtype).max
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / fmax
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """e4m3 forward, e5m2 for the gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x):
        return _q(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _q(g, torch.float8_e5m2)


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; e5m2 for the gradient of the result."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _q(g, torch.float8_e5m2)


def fp8_conv(x, w, stride, padding):
    y = F.conv2d(_Fp8Operand.apply(x), _Fp8Operand.apply(w), stride=stride, padding=padding)
    return _Fp8Grad.apply(y)
