"""Share of a traced stretch of extraction batches in which no device
activity ran."""


def read(records):
    tr = records.get("trace") if records.get("kind") == "embed" else None
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
