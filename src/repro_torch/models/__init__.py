"""Model code of the port: the dense transformer LM on the serving path."""

from .config import ModelConfig
from .convert import params_from_numpy
from .model import (decode_step, init_decode_caches, lm_init, param_count, prefill,
                    working_params)

__all__ = ["ModelConfig", "decode_step", "init_decode_caches", "lm_init",
           "param_count", "params_from_numpy", "prefill", "working_params"]
