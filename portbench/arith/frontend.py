"""FLOPs of the fbank frontend's matmuls: per frame, the folded real DFT
(two products of the 400-sample frame with 257 bins) and the mel
filterbank (257 bins to the mel bins)."""


def fbank_flops(batch: int, frames: int, window: int = 400, bins: int = 257,
                mels: int = 40) -> float:
    return 2.0 * batch * frames * (2 * window * bins + bins * mels)
