"""Host ms a train step spends in host-to-device copies (the program's
spans ``h2d``: the loader's index upload), a step, over the traced
stretch.  A copy from pageable memory waits for the stream to drain, so
this is the host's wait for the card plus the staging of the bytes."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "train":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "h2d", spans.TRAIN_UNIT, clock="host_ms")
