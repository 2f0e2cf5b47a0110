"""The flash AAM head's work, the same for any implementation of it.

Forward: 2·B·C·D operations for the cosines.  Backward: 3 x 2·B·C·D (the
cosines again, since the flash head keeps no (B, C) logits, then dê and
dW).  Bytes: each input read once and each output written once, in f32
(labels int64).  The least time is against the dense TF32 tensor-core
peak, the highest rate at which the card multiplies f32 inputs; the three
TF32 products of 3xTF32 belong to the implementation, not to the work.
"""

from portbench.arith.peaks import TF32_FLOPS, least_seconds


def fwd_work(B: int, C: int, D: int):
    """(flops, bytes) of the forward: reads ê (B, D), W (C, D), labels and
    the margined target logits (B,); writes lse, zy, the running max and
    the rank count (B,) each."""
    flops = 2.0 * B * C * D
    nbytes = 4.0 * (B * D + C * D) + 8.0 * B + 4.0 * B + 4 * 4.0 * B
    return flops, nbytes


def bwd_work(B: int, C: int, D: int):
    """(flops, bytes) of the backward: reads ê, W, labels, lse and the
    loss's gradient; writes dê (B, D) and dW (C, D)."""
    flops = 3 * 2.0 * B * C * D
    nbytes = 4.0 * (B * D + C * D) + 8.0 * B + 2 * 4.0 * B + 4.0 * (B * D + C * D)
    return flops, nbytes


def fwd_least_s(B: int, C: int, D: int) -> float:
    return least_seconds(*fwd_work(B, C, D), TF32_FLOPS)


def bwd_least_s(B: int, C: int, D: int) -> float:
    return least_seconds(*bwd_work(B, C, D), TF32_FLOPS)
