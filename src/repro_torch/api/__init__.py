"""Session-layer API of the port: ``ServeSession`` / ``ServeConfig``."""

from .config import ConfigError
from .serve import ServeConfig, ServeSession

__all__ = ["ConfigError", "ServeConfig", "ServeSession"]
