"""Compute ops: stats pooling, the dense AAM head, the flash AAM head."""

from pkr_tpu_torch.ops.stats_pool import stats_pool
from pkr_tpu_torch.ops.aam import aam_logits
from pkr_tpu_torch.ops.flash_aam import (
    flash_aam_bwd,
    flash_aam_fwd,
    flash_aam_loss,
    flash_aam_loss_acc,
)

__all__ = ["stats_pool", "aam_logits", "flash_aam_bwd", "flash_aam_fwd", "flash_aam_loss",
           "flash_aam_loss_acc"]
