"""Device ms of a train step's update (the program's span ``step.update``:
the gradient reduce, the BatchNorm commit and the SGD step), a step, over
the traced stretch."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "train":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "step.update", spans.TRAIN_UNIT)
