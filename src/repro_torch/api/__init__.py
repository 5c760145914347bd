"""Session-layer API of the port: ``Trainer`` / ``TrainerConfig`` and
``ServeSession`` / ``ServeConfig``."""

from .config import ConfigError, TrainerConfig
from .serve import ServeConfig, ServeSession
from .trainer import Trainer

__all__ = ["ConfigError", "ServeConfig", "ServeSession", "Trainer", "TrainerConfig"]
