"""Round-mode server-algorithm registry on the flat slab layout
(``repro.core.algos``).

A ``RoundAlgo`` binds a server rule to a ``DuDeEngine``: ``init()`` builds
its server state and ``round(state, fresh, start_mask, commit_mask)``
advances it one semi-async round, returning ``(state, g, applied)``.  For
the DuDe rule ``fused_apply`` is set: the train step does not call
``round`` but ``engine.round_apply``, the round fused with the flat
optimizer step (K1 on the pallas backend).

The slice ports ``dude``; ``dude_accum``, ``sync_sgd``, ``mifa`` and
``fedbuff`` (and the arrival-granularity registry) are not yet ported and
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .engine import DuDeEngine, EngineState

__all__ = ["ROUND_ALGOS", "RoundAlgo", "make_round_algo"]

# every round rule of the reference; the port runs the first
ROUND_ALGOS = ("dude", "dude_accum", "sync_sgd", "mifa", "fedbuff")


@dataclasses.dataclass(frozen=True)
class RoundAlgo:
    """One server update rule bound to an engine, for the round path."""

    name: str
    engine: DuDeEngine
    fused_apply: bool
    init_fn: Callable[[], Any]
    # (state, fresh [n, P], start_mask, commit_mask)
    #   -> (state, g [P] f32, applied scalar bool)
    round_fn: Callable[..., tuple]

    def init(self):
        return self.init_fn()

    def round(self, state, fresh, start_mask, commit_mask):
        return self.round_fn(state, fresh, start_mask.to(torch.bool),
                             commit_mask.to(torch.bool))


def _make_dude(engine: DuDeEngine) -> RoundAlgo:
    def round_fn(state: EngineState, fresh, sm, cm):
        state, g_bar = engine.round(state, fresh, sm, cm)
        return state, g_bar, torch.ones((), dtype=torch.bool, device=g_bar.device)

    return RoundAlgo("dude", engine, fused_apply=True, init_fn=engine.init,
                     round_fn=round_fn)


def make_round_algo(name: str, engine: DuDeEngine) -> RoundAlgo:
    """Build the named server rule bound to ``engine``."""
    if name == "dude":
        return _make_dude(engine)
    if name in ROUND_ALGOS:
        raise NotImplementedError(f"round algo {name!r} is not yet ported")
    raise ValueError(f"unknown round algo {name!r}; options: {ROUND_ALGOS}")
