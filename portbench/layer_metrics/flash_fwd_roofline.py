"""The flash head forward's share of its roofline: the least time of its
work at the cell's B x C x D (``arith/flash_aam.py``, against the TF32
tensor-core peak and HBM) over the mean CUDA-event time of the head's
forward as the train step calls it, whatever kernels it launches."""

from portbench.arith.flash_aam import fwd_least_s


def read(records):
    ms = records.get("flash_fwd_ms")
    if not ms:
        return None
    return 100.0 * fwd_least_s(*records["flash_shape"]) * 1e3 / (sum(ms) / len(ms))
