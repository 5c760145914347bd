"""Session configuration (``repro.api.config``): the typed
``ConfigError``, the architecture check shared by the session configs, and
``TrainerConfig``.

``TrainerConfig`` holds the knobs of the slice the port trains: one DuDe
round per step on one device, f32 slabs, the reference or the fused (K1)
backend.  Every other knob of the reference is absent or raises
``ConfigError("... not yet ported")`` here, before any device work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..core.algos import ROUND_ALGOS
from ..core.dude import DuDeConfig
from ..core.engine import BACKENDS
from ..models.config import ModelConfig
from ..optim import Optimizer, adamw, momentum_sgd, sgd

# name -> factory(lr) for the string form of ``TrainerConfig.optimizer``
OPTIMIZERS = {"sgd": sgd, "momentum": momentum_sgd, "adamw": adamw}

# the reference's server rules and engine backends the port does not run
# yet (named, so that asking for one says so)
_ALGOS_TO_PORT = ("dude_accum", "sync_sgd", "mifa", "fedbuff", "dude_const",
                  "dude_hinge", "dude_poly", "vanilla_asgd", "uniform_asgd",
                  "shuffled_asgd")
_BACKENDS_TO_PORT = ("indexed",)
_DTYPES = (torch.float32, torch.bfloat16)


class ConfigError(ValueError):
    """A ``TrainerConfig`` / ``ServeConfig`` field combination is invalid.

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


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """One training session.

    ``arch`` is a registry name (``repro_torch.configs``) or a
    ``ModelConfig``; ``smoke`` takes the registry's reduced CPU variant.
    ``optimizer`` is a name of ``OPTIMIZERS`` (built with ``lr``) or an
    ``Optimizer``.  ``server_backend`` is ``"reference"`` (the plain masked
    sweep, then the optimizer) or ``"pallas"`` (the fused round, K1).
    ``buffer_dtype`` (slabs) defaults to the arch's, f32 under smoke;
    ``grad_dtype`` (fresh slab) to f32.  The session runs on ``device``:
    ``"cuda"`` unless the caller asks for ``"cpu"``."""

    arch: Union[str, ModelConfig]
    smoke: bool = False
    algo: str = "dude"
    optimizer: Union[str, Optimizer] = "sgd"
    lr: float = 0.01
    server_backend: str = "reference"
    buffer_dtype: Optional[torch.dtype] = None
    grad_dtype: Optional[torch.dtype] = None
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.algo in _ALGOS_TO_PORT:
            raise ConfigError(f"algo {self.algo!r} is not yet ported (the port runs 'dude')")
        if self.algo != "dude":
            raise ConfigError(f"unknown algo {self.algo!r}; options: {ROUND_ALGOS}")
        if self.server_backend in _BACKENDS_TO_PORT:
            raise ConfigError(f"server_backend {self.server_backend!r} is not yet ported")
        if self.server_backend not in BACKENDS:
            raise ConfigError(f"unknown server_backend {self.server_backend!r}; "
                              f"options: {BACKENDS}")
        if isinstance(self.optimizer, str) and self.optimizer not in OPTIMIZERS:
            raise ConfigError(f"unknown optimizer {self.optimizer!r}; "
                              f"options: {tuple(OPTIMIZERS)} (or pass an Optimizer)")
        if isinstance(self.optimizer, str) and not self.lr > 0:
            raise ConfigError(f"lr={self.lr} must be > 0")
        for name in ("buffer_dtype", "grad_dtype"):
            dt = getattr(self, name)
            if dt is not None and dt not in _DTYPES:
                raise ConfigError(f"{name}={dt} is not torch.float32 or torch.bfloat16")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ConfigError(f"device={self.device!r} is not 'cuda' or 'cpu'")
        _check_arch(self.arch)

    @property
    def model_config(self) -> ModelConfig:
        if isinstance(self.arch, ModelConfig):
            return self.arch
        from ..configs import get_config
        cfg = get_config(self.arch)
        return cfg.smoke() if self.smoke else cfg

    @property
    def dude_config(self) -> DuDeConfig:
        cfg = self.model_config
        bdt = self.buffer_dtype
        if bdt is None:
            bdt = torch.float32 if self.smoke else cfg.dude_buffer_dtype
        return DuDeConfig(cfg.n_workers, bdt)

    def make_optimizer(self) -> Optimizer:
        if isinstance(self.optimizer, Optimizer):
            return self.optimizer
        return OPTIMIZERS[self.optimizer](self.lr)
