"""Host utilities of the port: training meters, progress logging, tracing,
the local job runner and the multi-host launchers."""

from pkr_tpu_torch.utils.logging import AverageMeter, ProgressLogger
from pkr_tpu_torch.utils.trace import profile_trace

__all__ = ["AverageMeter", "ProgressLogger", "profile_trace"]
