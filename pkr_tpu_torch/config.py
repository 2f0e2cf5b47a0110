"""One typed configuration object for the whole stack.

A copy of ``pkr_tpu/config.py`` for the port, built on the port's own
``FbankConfig``, ``FrontendConfig`` and ``VadConfig``.  Every field is kept,
including those the port does not act on yet (``train.model_parallel`` and
``data``'s augmentation-pool fields), so that a JSON written by either
package's ``Config.to_json`` loads unchanged in the other.

Replaces the reference's three config tiers — recipe shell variables
(run_aam_v2.sh:26-43), parse_options.sh flag plumbing, and per-binary Kaldi
conf files + python argparse — with a single dataclass tree that serializes
to/from JSON and maps 1:1 onto recipe stages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

from pkr_tpu_torch.frontend.features import FbankConfig
from pkr_tpu_torch.frontend.pipeline import FrontendConfig
from pkr_tpu_torch.frontend.vad import VadConfig


@dataclass(frozen=True)
class ModelConfig:
    trunk: str = "resnet34"
    pooling: str = "mean+std"
    loss: str = "softmax"  # softmax | AAM | AAM-v1
    feat_dim: int = 40
    emb_dim: int = 256
    margin: float = 0.2  # run_aam_v2.sh:32
    scale: float = 30.0  # run_aam_v2.sh:33


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 30
    batch_size: int = 1024  # global (run_aam_v2.sh:34)
    lr: float = 0.1
    lr_final: float = 0.0
    momentum: float = 0.9
    weight_decay: float = 5e-4
    chunk_size: Tuple[int, ...] = (200,)  # fixed 200 (run_aam_v2.sh:71)
    dataset: str = "v1"  # v1 balanced-repetition | v2 speaker-balanced
    seed: int = 777
    print_freq: int = 100
    pretrained: Optional[str] = None
    resume: bool = False
    flash_aam: bool = False  # the flash classifier loss (large spk counts)
    device_cache: bool = False  # card-resident quantized features
    save_every_steps: int = 0  # mid-epoch preemption-safety saves (0 = off)
    keep_last_checkpoints: int = 0  # prune old per-epoch dirs (0 = keep all)
    profile_dir: Optional[str] = None  # torch.profiler trace of steady steps
    profile_steps: int = 10
    model_parallel: int = 1  # classifier tensor parallel (not in the port yet)


@dataclass(frozen=True)
class EvalConfig:
    backend: str = "snorm"  # cosine | snorm | plda | pool
    topk: int = 300  # cohort top-k (compute_topk_mean_std.py:10)
    p_targets: Tuple[float, ...] = (0.01, 0.001)  # test.sh:68-69
    batch_size: int = 8
    chunk_size: int = -1
    bucket_quantum: int = 100
    max_len: int = 3000
    long_mode: str = "truncate"  # or 'average': window-mean very long audio
    lda_dim: int = 200  # run.sh:331
    # random train subset for backend/cohort stats extraction (stage 4);
    # 0 = whole train scp (feature_pre.sh:244-246 uses `shuf | head -500000`)
    cohort_subset: int = 0
    # 'auto' ships CM-compressed features to the card as uint8 codes and
    # dequantizes there (values identical, 4x less H2D traffic); 'f32'
    # forces the float transfer path
    transport: str = "auto"


@dataclass(frozen=True)
class DataConfig:
    min_frames: int = 200  # feature_pre.sh:204
    cv_fraction: float = 0.05
    augment: bool = True
    snr_noise: Tuple[int, ...] = (15, 10, 5, 0)  # run.sh:136-144
    snr_music: Tuple[int, ...] = (15, 10, 8, 5)
    snr_babble: Tuple[int, ...] = (20, 17, 15, 13)
    # full-corpus augmentation pools: per-recording head length, device
    # memory per pool shard, shard-rotation cadence in utterances
    pool_len_sec: float = 12.0
    pool_shard_mb: int = 256
    pool_rotate_rows: int = 2000
    # stage-1 host fan-out (the reference's nj role, make_fbank.sh:118-126):
    # wav-decode thread count and CM-encode worker count (per-shard arks)
    decode_jobs: int = 4
    encode_workers: int = 1


@dataclass(frozen=True)
class Config:
    exp_dir: str = "exp/default"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: DataConfig = field(default_factory=DataConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        nested = {"model": ModelConfig, "train": TrainConfig, "eval": EvalConfig,
                  "data": DataConfig, "frontend": FrontendConfig,
                  "fbank": FbankConfig, "vad": VadConfig}

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if f.name in nested:
                    kw[f.name] = build(nested[f.name], v)
                elif isinstance(v, list):
                    kw[f.name] = tuple(v)
                else:
                    kw[f.name] = v
            return cls(**kw)

        return build(Config, raw)
