"""Model zoo of the port: the ResNet trunks (BasicBlock, SE, Bottleneck and
thin), the DenseNet trunks, the speaker-embedding model with softmax/AAM
heads, and the trunks' memory layout per device."""

from pkr_tpu_torch.models.densenet import (
    DENSENETS,
    DenseNet,
    densenet62,
    densenet115,
    densenet121,
    densenet161,
    densenet169,
    densenet201,
)
from pkr_tpu_torch.models.layout import memory_format_for, use_device_layout
from pkr_tpu_torch.models.resnet import (
    BatchNorm,
    ResNet,
    ThinResNet,
    commit_batch_stats,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    se_resnet34,
    set_batch_norm_group,
    thin_resnet34,
    tiny_resnet,
)
from pkr_tpu_torch.models.speaker_model import SpeakerModel

__all__ = [
    "BatchNorm",
    "ResNet",
    "ThinResNet",
    "commit_batch_stats",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "se_resnet34",
    "set_batch_norm_group",
    "thin_resnet34",
    "tiny_resnet",
    "DENSENETS",
    "DenseNet",
    "densenet62",
    "densenet115",
    "densenet121",
    "densenet161",
    "densenet169",
    "densenet201",
    "SpeakerModel",
    "memory_format_for",
    "use_device_layout",
]
