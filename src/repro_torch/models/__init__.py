"""Model code of the port: the dense transformer LM, for training and
serving."""

from .config import ModelConfig
from .convert import params_from_numpy, params_from_stacked, stack_params
from .model import (decode_step, forward, init_decode_caches, lm_init, loss_fn,
                    param_count, prefill, working_params)

__all__ = ["ModelConfig", "decode_step", "forward", "init_decode_caches", "lm_init",
           "loss_fn", "param_count", "params_from_numpy", "params_from_stacked",
           "prefill", "stack_params", "working_params"]
