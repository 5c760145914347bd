"""Serving step factories (``repro.launch.steps.make_prefill_step`` and
``make_decode_step``).  The reference jits and shards these closures; the
port runs them eagerly on one device."""

from __future__ import annotations

from typing import Callable

from ..models.config import ModelConfig
from ..models.model import decode_step, prefill


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, caches):
        return prefill(params, batch, caches, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, use_window: bool = False) -> Callable:
    def serve_step(params, tokens, caches, index: int):
        return decode_step(params, tokens, caches, index, cfg, use_window=use_window)

    return serve_step
