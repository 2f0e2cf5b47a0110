"""The program's own spans and counters (``pkr_tpu_torch.utils.trace``),
as the readers of the per-layer metrics on them take them.

The program's tracer records while a profiler records: in a run with
``--trace 1``, while the cell traces its steady stretch (each try of
it).  So its summary after the run is that stretch's, and a reader gives
a mean a train step (an occurrence of the span ``step.forward``) or an
embed batch (of ``extract.embed``).  A program without the tracer, or a
run that recorded none of a reader's spans, gives None.
"""

from __future__ import annotations

from typing import Optional

TRAIN_UNIT = "step.forward"  # one a train step
EMBED_UNIT = "extract.embed"  # one an embed batch


def program_summary() -> Optional[dict]:
    """The program's ``trace.summary()``, or None where it has no tracer."""
    try:
        import pkr_tpu_torch.utils.trace as trace
    except ImportError:
        return None
    return trace.summary()


def per_unit_ms(summary: Optional[dict], span: str, unit: str,
                clock: str = "device_ms") -> Optional[float]:
    """The ms of ``span`` on ``clock`` (``device_ms`` or ``host_ms``) a unit
    of work, one occurrence of the span ``unit``: the mean of its kept
    records times its occurrences a unit."""
    spans = (summary or {}).get("spans", {})
    s, u = spans.get(span), spans.get(unit)
    if not s or not s.get(clock) or not u or not u.get("n"):
        return None
    ms = s[clock]
    return sum(ms) / len(ms) * s["n"] / u["n"]


def per_unit_count(summary: Optional[dict], counter: str, unit: str) -> Optional[float]:
    """The counter ``counter``'s total a unit of work (None where it never
    counted)."""
    spans = (summary or {}).get("spans", {})
    total = (summary or {}).get("counters", {}).get(counter)
    u = spans.get(unit)
    if not total or not u or not u.get("n"):
        return None
    return total / u["n"]
