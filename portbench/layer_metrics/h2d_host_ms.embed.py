"""Host ms an embed batch spends in host-to-device copies (the program's
spans ``h2d``: the wavs, their lengths and the frontend's three matrices),
a batch, over the traced stretch: the host's wait for the card plus the
staging of the bytes."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "embed":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "h2d", spans.EMBED_UNIT, clock="host_ms")
