from .checkpoints import (checkpoint_path, load_checkpoint, load_optimizer_state,
                          resolve_checkpoint, save_optimizer_state)
from .interop import load_pth, params_from_jax, save_pth
from .loop import (DensePass, TrainState, dense_eval_rmse, dense_predict_all,
                   dense_train_epoch, eval_rmse, eval_rmse_ensemble,
                   get_learning_rate, loss_fn, make_eval_step, make_optimizer,
                   make_train_step, plan_buckets, plan_dense_epoch, predict_all,
                   set_learning_rate, test_once, train_epoch,
                   train_multiple_epochs)

__all__ = ["DensePass", "TrainState", "checkpoint_path", "dense_eval_rmse",
           "dense_predict_all", "dense_train_epoch", "eval_rmse",
           "eval_rmse_ensemble", "get_learning_rate", "load_checkpoint",
           "load_optimizer_state", "load_pth", "loss_fn", "make_eval_step",
           "make_optimizer", "make_train_step", "params_from_jax",
           "plan_buckets", "plan_dense_epoch", "predict_all",
           "resolve_checkpoint", "save_optimizer_state", "save_pth",
           "set_learning_rate", "test_once", "train_epoch",
           "train_multiple_epochs"]
