"""MB (10^6 bytes) an embed batch sends from the host to the card (the
program's counter ``h2d.bytes``), a batch, over the traced stretch."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "embed":
        return None
    summary = spans.program_summary() if summary is None else summary
    n = spans.per_unit_count(summary, "h2d.bytes", spans.EMBED_UNIT)
    return None if n is None else n / 1e6
