from bbocr_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    craft_loss,
    create_train_state,
    crnn_loss,
    make_joint_train_step,
    make_optimizer,
    make_schedule,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "craft_loss",
    "create_train_state",
    "crnn_loss",
    "make_joint_train_step",
    "make_optimizer",
    "make_schedule",
]
