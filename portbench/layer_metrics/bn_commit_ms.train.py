"""Device ms of a train step's BatchNorm commit (the program's span
``step.bn_commit`` around ``commit_batch_stats``, inside ``step.update``),
a step, over the traced stretch."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "train":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "step.bn_commit", spans.TRAIN_UNIT)
