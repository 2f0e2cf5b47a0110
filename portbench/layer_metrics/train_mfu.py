"""The train step's share of the card's dense bf16 peak: the step's FLOPs
(3x the forward of the convolutions, fc1 and the head; ``arith/resnet.py``)
over the mean step interval (CUDA events) of the untraced steps."""

from portbench.arith.peaks import BF16_FLOPS


def read(records):
    ms = records.get("untraced_step_ms") if records.get("kind") == "train" else None
    if not ms:
        return None
    return 100.0 * records["train_flops"] / (sum(ms) / len(ms) * 1e-3) / BF16_FLOPS
