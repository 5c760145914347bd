"""The ``Trainer`` session (``repro.api.trainer``): one object, one flat
train state, one step signature.

``Trainer.create(config)`` resolves a ``TrainerConfig`` into a live
session: the model config, the ``DuDeEngine``, the ``RoundAlgo`` and the
flat optimizer twin, and one ``FlatTrainState`` whose master params,
optimizer slots and server slabs all live in the engine's ``[P]`` layout
on ``config.device``.  Then

    metrics = trainer.step(batch, start_mask, commit_mask)

runs one semi-async DuDe round.  On the pallas backend the state is
updated in place by K1 (the reference donates it to its jitted step).
``params()`` hands out the model's params as views of the master vector,
which ``ServeSession.create(..., params=...)`` takes.  Restoring from a
checkpoint, the async runtime and the lowering helpers are not yet ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.algos import make_round_algo
from ..launch.steps import init_flat_train_state, make_engine, make_train_step
from ..models import lm_init, params_from_stacked
from ..optim import FlatTrainState, flat_twin
from .config import ConfigError, TrainerConfig

__all__ = ["Trainer"]


class Trainer:
    """A live training session over the single flat train state."""

    def __init__(self, config: TrainerConfig):
        self.config = config
        self.cfg = config.model_config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device is available; pass "
                               "device='cpu' to run the plain versions on the CPU")
        self.opt = config.make_optimizer()
        self.fopt = flat_twin(self.opt)
        self.dude_cfg = config.dude_config
        self.engine = make_engine(self.cfg, self.dude_cfg, backend=config.server_backend,
                                  device=self.device)
        self.algo = make_round_algo(config.algo, self.engine)
        self.state: Optional[FlatTrainState] = None
        self.rounds = 0
        self.step_fn = make_train_step(self.cfg, self.opt, self.dude_cfg, engine=self.engine,
                                       algo=self.algo, grad_dtype=config.grad_dtype)

    @classmethod
    def create(cls, config: TrainerConfig, params: Optional[dict] = None) -> "Trainer":
        """Fresh session: params from a ``torch.Generator`` seeded with
        ``config.seed`` on the session's device, or the given params (the
        port's layout, on that device; they are copied into the flat
        master vector)."""
        t = cls(config)
        if params is None:
            gen = torch.Generator(device=t.device).manual_seed(config.seed)
            params = lm_init(gen, t.cfg, t.device)
        t.state = init_flat_train_state(t.engine, t.opt, params, algo=t.algo)
        return t

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x, dtype=dtype).to(self.device, non_blocking=True)

    def step(self, batch: dict, start_mask, commit_mask) -> dict:
        """Advance one semi-async round.  ``batch`` holds worker-stacked
        ``tokens``/``labels`` ``[n, B, S]`` and the masks are ``[n]`` bool
        (numpy arrays or tensors).  Updates ``self.state`` and returns the
        metrics (``loss``, ``applied``) as device tensors."""
        if self.state is None:
            raise ConfigError("session has no state; use Trainer.create")
        batch = {k: self._tensor(v) for k, v in batch.items()}
        self.state, metrics = self.step_fn(self.state, batch,
                                           self._tensor(start_mask, torch.bool),
                                           self._tensor(commit_mask, torch.bool))
        self.rounds += 1
        return metrics

    def params(self) -> dict:
        """The master params in the model's layout, as views of the flat
        master vector (f32)."""
        return params_from_stacked(self.engine.spec.unravel(self.state.params), self.cfg)

    def param_count(self) -> int:
        return self.engine.spec.size
