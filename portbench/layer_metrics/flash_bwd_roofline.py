"""The flash head backward's share of its roofline: the least time of its
work (the cosines again, dê and dW; ``arith/flash_aam.py``) over the mean
CUDA-event time from the loss's gradient reaching the head to the
gradients of emb and W leaving it."""

from portbench.arith.flash_aam import bwd_least_s


def read(records):
    ms = records.get("flash_bwd_ms")
    if not ms:
        return None
    return 100.0 * bwd_least_s(*records["flash_shape"]) * 1e3 / (sum(ms) / len(ms))
