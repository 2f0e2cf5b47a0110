"""Device ms of a train step's forward (the program's span ``step.forward``:
the model, the loss and the metrics, dense or flash head), a step, over
the traced stretch (CUDA events at the span's ends)."""

from portbench import spans


def read(records, summary=None):
    if records.get("kind") != "train":
        return None
    summary = spans.program_summary() if summary is None else summary
    return spans.per_unit_ms(summary, "step.forward", spans.TRAIN_UNIT)
