"""Device ms of an embed batch's trunk (the program's span
``extract.embed``: the trunk in eval mode, the pooling and fc1), a batch,
over the traced stretch."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "embed":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "extract.embed", spans.EMBED_UNIT)
