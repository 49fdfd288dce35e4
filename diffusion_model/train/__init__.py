from diffusion_model.train.loss import (
    diffuse_batch,
    epsilon_loss,
    t_band_weights,
)
from diffusion_model.train.trainer import (
    EarlyStopping,
    TrainState,
    Trainer,
    make_optimizer,
)
from diffusion_model.train.checkpoint import (
    save_checkpoint,
    restore_checkpoint,
    latest_step,
)

__all__ = [
    "diffuse_batch",
    "epsilon_loss",
    "t_band_weights",
    "EarlyStopping",
    "TrainState",
    "Trainer",
    "make_optimizer",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
