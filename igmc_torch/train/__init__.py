from .checkpoints import (checkpoint_path, load_checkpoint, load_optimizer_state,
                          resolve_checkpoint, save_optimizer_state)
from .interop import load_pth, params_from_jax, save_pth
from .loop import (TrainState, eval_rmse, eval_rmse_ensemble, get_learning_rate,
                   loss_fn, make_eval_step, make_optimizer, make_train_step,
                   predict_all, set_learning_rate, test_once, train_epoch,
                   train_multiple_epochs)

__all__ = ["TrainState", "checkpoint_path", "eval_rmse", "eval_rmse_ensemble",
           "get_learning_rate", "load_checkpoint", "load_optimizer_state",
           "load_pth", "loss_fn", "make_eval_step", "make_optimizer",
           "make_train_step", "params_from_jax", "predict_all",
           "resolve_checkpoint", "save_optimizer_state", "save_pth",
           "set_learning_rate", "test_once", "train_epoch",
           "train_multiple_epochs"]
