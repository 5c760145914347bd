"""DuDe-ASGD configuration (``repro.core.dude.DuDeConfig``).

The round itself runs on the flat slabs of ``core/engine.py``; the
reference's pytree wrappers (``dude_commit`` / ``dude_round``) wait for the
port's simulator.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DuDeConfig"]


@dataclasses.dataclass(frozen=True)
class DuDeConfig:
    n_workers: int
    buffer_dtype: torch.dtype = torch.float32
    # (the reference's beyond-paper ``accumulate`` latch is not yet ported)
