"""Host utilities of the port: training meters, progress logging, tracing."""

from pkr_tpu_torch.utils.logging import AverageMeter, ProgressLogger, profile_trace

__all__ = ["AverageMeter", "ProgressLogger", "profile_trace"]
