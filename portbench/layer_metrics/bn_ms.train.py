"""Device ms a train step spends in BatchNorm kernels, from the profiler's
trace of a steady stretch, by the bucket rule of ``arith/buckets.py``."""

from portbench.arith.buckets import buckets


def read(records):
    tr = records.get("trace") if records.get("kind") == "train" else None
    if not tr or not records.get("trace_steps"):
        return None
    b = buckets(tr["by_name_s"])
    if abs(sum(b.values()) - sum(tr["by_name_s"].values())) > 1e-9:
        raise ValueError("the buckets do not sum to the traced device time")
    if b["batchnorm"] <= 0.0:
        return None
    return b["batchnorm"] * 1e3 / records["trace_steps"]
