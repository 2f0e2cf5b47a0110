"""Training meters and structured progress logging.

The port's own copy of ``AverageMeter`` and ``ProgressLogger`` from
``pkr_tpu/utils/logging.py`` (plain-text lines plus an optional JSONL
metrics stream).  ``profile_trace``, the profiler window, lives with the
port's spans in ``utils/trace.py`` and is importable from here too.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

from pkr_tpu_torch.utils.trace import profile_trace  # noqa: F401


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":.4f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class ProgressLogger:
    """Plain-text lines to a stream + optional JSONL metrics file."""

    def __init__(self, stream: Optional[TextIO] = None,
                 jsonl_path: Optional[str] = None, prefix: str = ""):
        self.stream = stream if stream is not None else sys.stdout
        self.prefix = prefix
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def log(self, msg: str, **metrics):
        stamp = time.strftime("%H:%M:%S")
        self.stream.write(f"[{stamp}] {self.prefix}{msg}\n")
        self.stream.flush()
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"t": time.time(), "msg": msg, **metrics}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
