"""Host-side input pipeline (balanced samplers, chunking, prefetch), the
card-resident quantized feature cache (one shard a rank over a process
mesh), and waveform augmentation on the card (``data.augment``)."""

from pkr_tpu_torch.data.sampler import (
    BalancedRepetitionSampler,
    SpeakerBalancedSampler,
    load_utt2spkid,
)
from pkr_tpu_torch.data.loader import FeatureSource, TrainLoader, EvalLoader, bucket_lengths
from pkr_tpu_torch.data.device_cache import (
    DeviceCacheLoader,
    DeviceFeatureCache,
    ShardedCacheLoader,
    ShardedDeviceFeatureCache,
)
from pkr_tpu_torch.data.materialize import MaterializedSource, materialize

__all__ = [
    "BalancedRepetitionSampler",
    "SpeakerBalancedSampler",
    "load_utt2spkid",
    "FeatureSource",
    "TrainLoader",
    "EvalLoader",
    "bucket_lengths",
    "DeviceFeatureCache",
    "DeviceCacheLoader",
    "ShardedDeviceFeatureCache",
    "ShardedCacheLoader",
    "MaterializedSource",
    "materialize",
]
