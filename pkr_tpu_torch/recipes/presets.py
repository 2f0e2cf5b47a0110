"""Config presets mirroring each reference recipe driver.

A copy of ``pkr_tpu/recipes/presets.py``: every run*.sh becomes a named
Config; ``python -m pkr_tpu_torch.recipes.run --preset aam_v2 ...``
reproduces the corresponding experiment's hyperparameters on the card.
"""

from __future__ import annotations

from pkr_tpu_torch.config import (Config, DataConfig, EvalConfig, ModelConfig,
                                  TrainConfig)


def softmax_plda() -> Config:
    """run.sh — softmax training (imagenet_main.py), LDA(200)+PLDA backend.
    Published numbers: EER 3.043 / minDCF 0.3129, 0.4291 (run.sh:361-363)."""
    return Config(
        exp_dir="exp/softmax_plda",
        model=ModelConfig(loss="softmax", pooling="mean+std"),
        train=TrainConfig(epochs=30, batch_size=1024, lr=0.1, lr_final=0.0,
                          chunk_size=(200,)),
        eval=EvalConfig(backend="plda", lda_dim=200),
    )


def rvector() -> Config:
    """run_rvector.sh — softmax r-vector + PLDA/cosine eval."""
    cfg = softmax_plda()
    return Config(exp_dir="exp/rvector", model=cfg.model, train=cfg.train,
                  eval=EvalConfig(backend="plda"))


def aam_v2() -> Config:
    """run_aam_v2.sh — the main AAM recipe: m=0.2 s=30 wd=5e-4, cosine LR
    0.1→0, 30 epochs, batch 1024, chunk 200, adaptive-S-norm scoring
    (run_aam_v2.sh:26-43)."""
    return Config(
        exp_dir="exp/aam_v2",
        model=ModelConfig(loss="AAM", margin=0.2, scale=30.0, pooling="mean+std"),
        train=TrainConfig(epochs=30, batch_size=1024, lr=0.1, lr_final=0.0,
                          chunk_size=(200,), weight_decay=5e-4,
                          pretrained="exp/softmax_plda/checkpoints"),
        eval=EvalConfig(backend="snorm", topk=300),
    )


def aam_v1() -> Config:
    """run_aam_v1.sh — AAM-v1 loss (BN+ReLU before the margin head)."""
    cfg = aam_v2()
    return Config(exp_dir="exp/aam_v1",
                  model=ModelConfig(loss="AAM-v1", margin=0.2, scale=30.0,
                                    pooling="mean+std"),
                  train=cfg.train, eval=cfg.eval)


def aam_v2_finetune() -> Config:
    """run_aam_v2_lr0.001.sh — fine-tune AAM from the v2 AAM checkpoint
    (despite the name it runs lr 0.1 — run_aam_v2_lr0.001.sh:74)."""
    cfg = aam_v2()
    return Config(exp_dir="exp/aam_v2_ft", model=cfg.model,
                  train=TrainConfig(epochs=30, batch_size=1024, lr=0.1,
                                    chunk_size=(200,), weight_decay=5e-4,
                                    pretrained="exp/aam_v2/checkpoints"),
                  eval=cfg.eval)


def aam_dataset2() -> Config:
    """run_aam_dataset2.sh — speaker-balanced sampling (--dataset v2),
    snorm-only test."""
    cfg = aam_v2()
    return Config(exp_dir="exp/aam_dataset2", model=cfg.model,
                  train=TrainConfig(epochs=30, batch_size=1024, lr=0.1,
                                    chunk_size=(200,), weight_decay=5e-4,
                                    dataset="v2",
                                    pretrained="exp/aam_v2/checkpoints"),
                  eval=cfg.eval)


def aam_cpu_debug() -> Config:
    """run_aam_cpu.sh — tiny CPU smoke (run with --device cpu)."""
    return Config(
        exp_dir="exp/debug",
        model=ModelConfig(loss="AAM", trunk="tiny_resnet"),
        train=TrainConfig(epochs=3, batch_size=8, lr=0.1, chunk_size=(50,),
                          print_freq=10),
        eval=EvalConfig(backend="cosine", bucket_quantum=50, max_len=300,
                        batch_size=4),
        data=DataConfig(min_frames=50, cv_fraction=0.25, augment=False),
    )


PRESETS = {
    "softmax_plda": softmax_plda,
    "rvector": rvector,
    "aam_v2": aam_v2,
    "aam_v1": aam_v1,
    "aam_v2_finetune": aam_v2_finetune,
    "aam_dataset2": aam_dataset2,
    "aam_cpu_debug": aam_cpu_debug,
}
