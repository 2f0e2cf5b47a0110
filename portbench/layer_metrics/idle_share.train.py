"""Share of a traced stretch of train steps in which no device activity
ran (the union of the profiler's device activities against the stretch
between the two marker kernels)."""


def read(records):
    tr = records.get("trace") if records.get("kind") == "train" else None
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
