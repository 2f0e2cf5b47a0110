"""Device ms of the frontend a batch (wav_to_train_feats: framing, fbank,
VAD, CMVN, voiced selection, the wavs' upload included), from CUDA events
around each call in the window, averaged over the window."""


def read(records):
    ms = records.get("frontend_ms") if records.get("kind") == "embed" else None
    return sum(ms) / len(ms) if ms else None
