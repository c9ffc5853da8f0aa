from .checkpoint import apply_row_permutations, load_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state, lr_schedule
from .train_step import Trainer, lm_loss

__all__ = ["AdamWConfig", "OptState", "Trainer", "adamw_update", "apply_row_permutations",
           "init_opt_state", "load_checkpoint", "lm_loss", "lr_schedule", "save_checkpoint"]
