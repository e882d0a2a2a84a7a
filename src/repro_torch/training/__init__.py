from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.train import TrainState, make_train_step, train_loop

__all__ = ["AdamWState", "adamw_init", "adamw_update", "TrainState",
           "make_train_step", "train_loop"]
