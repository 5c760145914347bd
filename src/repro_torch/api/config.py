"""Typed configuration errors and the architecture check shared by the
port's session configs (``repro.api.config``)."""

from __future__ import annotations

from ..models.config import ModelConfig


class ConfigError(ValueError):
    """A ``ServeConfig`` field combination is invalid.

    Raised at config construction time, before any device work, so a caller
    can report it as a usage error rather than a mid-run crash."""


def _check_arch(arch) -> None:
    """A string ``arch`` must resolve through the registry, including the
    dashed aliases ``get_config`` accepts (e.g. ``"qwen2-0.5b"``)."""
    if isinstance(arch, ModelConfig):
        return
    from ..configs import get_config
    try:
        get_config(arch)
    except ValueError as e:
        raise ConfigError(str(e)) from None
