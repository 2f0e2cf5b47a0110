"""Training engine of the port: state, optimizer, train and eval steps, the
epoch loop, checkpoints."""

from pkr_tpu_torch.train.state import TrainState, cosine_epoch_lr, create_train_state
from pkr_tpu_torch.train.loop import (
    cross_entropy,
    make_eval_step,
    make_train_step,
    topk_correct,
    train_and_validate,
)
from pkr_tpu_torch.train.checkpoint import (
    import_torch_checkpoint,
    load_pretrained,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
    warm_start,
)

__all__ = [
    "TrainState",
    "cosine_epoch_lr",
    "create_train_state",
    "cross_entropy",
    "make_eval_step",
    "make_train_step",
    "topk_correct",
    "train_and_validate",
    "import_torch_checkpoint",
    "load_pretrained",
    "restore_checkpoint",
    "save_checkpoint",
    "wait_for_checkpoints",
    "warm_start",
]
