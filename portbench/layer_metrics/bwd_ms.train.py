"""Device ms of a train step's backward (the program's span
``step.backward``, around ``torch.autograd.grad``), a step, over the
traced stretch."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "train":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "step.backward", spans.TRAIN_UNIT)
