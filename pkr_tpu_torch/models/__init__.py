"""Model zoo of the port: ResNet trunks and the speaker-embedding model with
softmax/AAM heads.  The SE, thin, bottleneck and DenseNet trunks of
``pkr_tpu.models`` are not ported yet."""

from pkr_tpu_torch.models.resnet import (
    BatchNorm,
    ResNet,
    commit_batch_stats,
    resnet18,
    resnet34,
    tiny_resnet,
)
from pkr_tpu_torch.models.speaker_model import SpeakerModel

__all__ = [
    "BatchNorm",
    "ResNet",
    "commit_batch_stats",
    "resnet18",
    "resnet34",
    "tiny_resnet",
    "SpeakerModel",
]
