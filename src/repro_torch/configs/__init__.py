"""Architecture registry: ``get_config(arch_id)``.

Only the architectures the port serves so far are registered; the others of
``repro.configs`` follow with their block kinds.
"""

from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

ARCH_IDS = ("qwen2_0_5b",)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({"qwen2-0.5b": "qwen2_0_5b"})


def get_config(name: str) -> ModelConfig:
    key = _ALIASES.get(name, name)
    if key not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(_ALIASES)}")
    return import_module(f"repro_torch.configs.{key}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
