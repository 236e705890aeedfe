from .losses import (
    FlowMatchLossConfig,
    ddpm_sample_timesteps,
    flow_noise_and_target,
    masked_mse_loss,
    sample_flow_sigmas,
)
from .trainer import (
    TrainConfig,
    TrainState,
    adaptive_clip_by_global_norm,
    create_train_state,
    lr_multiplier_tree,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "FlowMatchLossConfig",
    "TrainConfig",
    "TrainState",
    "adaptive_clip_by_global_norm",
    "create_train_state",
    "ddpm_sample_timesteps",
    "flow_noise_and_target",
    "lr_multiplier_tree",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "masked_mse_loss",
    "sample_flow_sigmas",
]
