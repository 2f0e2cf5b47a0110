"""The extraction's share of the card's dense bf16 peak: the forward FLOPs
of the frontend's matmuls and of the trunk and fc1 at the frames the trunk
runs (``arith/``) over the window's time a batch (host clock), the
traced stretch and the reading of its trace left out."""

from portbench.arith.peaks import BF16_FLOPS


def read(records):
    if records.get("kind") != "embed" or not records.get("batches"):
        return None
    per_batch_s = records["window_s"] / records["batches"]
    return 100.0 * records["batch_flops"] / per_batch_s / BF16_FLOPS
