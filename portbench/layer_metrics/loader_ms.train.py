"""Device ms of each batch the program's loader yields (DeviceCacheLoader:
the sampler's indices to the card, one gather, the decode), from CUDA
events around each yield in the window, averaged over the window."""


def read(records):
    ms = records.get("loader_ms") if records.get("kind") == "train" else None
    return sum(ms) / len(ms) if ms else None
