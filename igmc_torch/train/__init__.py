from .checkpoints import checkpoint_path, load_checkpoint, resolve_checkpoint
from .interop import load_pth, params_from_jax, save_pth
from .loop import (eval_rmse, eval_rmse_ensemble, make_eval_step, predict_all,
                   test_once)

__all__ = ["checkpoint_path", "eval_rmse", "eval_rmse_ensemble", "load_checkpoint",
           "load_pth", "make_eval_step", "params_from_jax", "predict_all",
           "resolve_checkpoint", "save_pth", "test_once"]
