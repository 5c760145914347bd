"""Optimizers on the flat slab layout (``repro.optim.transforms``).

``sgd`` / ``momentum_sgd`` / ``adamw`` are the optimizer descriptors a
session is configured with (a name and its hyperparameters); the pytree
``init``/``apply`` of the reference waits for the port's baselines.  Each
has a **flat twin** (``FlatOptimizer``, built by ``flat_twin``) that works
on the engine's padded ``[P]`` slab layout (``core/flatten.py``): master
params are one f32 ``[P]`` vector and the slots are ``[P]`` f32 slabs
(momentum ``m``, AdamW ``{m, v}``).

``FlatOptimizer.update`` follows the reference op for op, and the fused
round kernel K1 (``csrc/dude_update.cu``) follows the same order, so the
fused and unfused applies agree to the rounding of the round's sum.  Zero
is a fixed point of all three rules, so the pad lanes never drift.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

__all__ = [
    "Optimizer", "sgd", "momentum_sgd", "adamw",
    "FlatOptState", "FlatOptimizer", "FlatTrainState",
    "flat_sgd", "flat_momentum_sgd", "flat_adamw",
    "FLAT_OPTIMIZERS", "flat_twin",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer's name and hyperparameters, as a static ``(key, value)``
    tuple from which ``flat_twin`` builds the flat optimizer."""

    name: str
    hparams: tuple = ()


def sgd(lr: float) -> Optimizer:
    return Optimizer("sgd", (("lr", lr),))


def momentum_sgd(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    return Optimizer("momentum", (("lr", lr), ("beta", beta), ("nesterov", nesterov)))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    return Optimizer("adamw", (("lr", lr), ("b1", b1), ("b2", b2), ("eps", eps),
                               ("weight_decay", weight_decay)))


class FlatOptState(NamedTuple):
    """Optimizer state on the flat layout: the step counter (a 0-dim i32
    device tensor) and the slots, ``()`` for sgd, ``m`` for momentum,
    ``{m, v}`` for AdamW, each a ``[P]`` f32 slab."""

    step: torch.Tensor
    slots: Any


class FlatTrainState(NamedTuple):
    """The whole training state as flat slabs: f32 master params ``[P]``,
    the flat optimizer state and the DuDe ``EngineState``.  Built by
    ``launch.steps.init_flat_train_state``."""

    params: torch.Tensor
    opt: FlatOptState
    engine: Any


@dataclasses.dataclass(frozen=True)
class FlatOptimizer:
    """Flat-slab optimizer on ``[P]`` f32 vectors.  ``update(params, g,
    slots, t)`` is the elementwise step (``t`` = the step after the
    increment, a device tensor); it is what the engine's reference backend
    applies after the round, and what K1 fuses into the round."""

    name: str
    hparams: tuple = ()

    @property
    def hp(self) -> dict:
        return dict(self.hparams)

    def init_slots(self, params_flat: torch.Tensor):
        z = lambda: torch.zeros_like(params_flat, dtype=torch.float32)
        if self.name == "sgd":
            return ()
        if self.name == "momentum":
            return z()
        if self.name == "adamw":
            return {"m": z(), "v": z()}
        raise ValueError(f"unknown flat optimizer {self.name!r}")

    def init(self, params_flat: torch.Tensor) -> FlatOptState:
        step = torch.zeros((), dtype=torch.int32, device=params_flat.device)
        return FlatOptState(step, self.init_slots(params_flat))

    def update(self, params: torch.Tensor, g: torch.Tensor, slots, t: torch.Tensor):
        """One elementwise step on ``[P]`` slabs; returns ``(params, slots)``."""
        hp = self.hp
        g = g.float()
        if self.name == "sgd":
            return params - hp["lr"] * g, slots
        if self.name == "momentum":
            beta = hp["beta"]
            m = beta * slots + g
            d = beta * m + g if hp["nesterov"] else m
            return params - hp["lr"] * d, m
        if self.name == "adamw":
            b1, b2 = hp["b1"], hp["b2"]
            m = b1 * slots["m"] + (1 - b1) * g
            v = b2 * slots["v"] + (1 - b2) * torch.square(g)
            bc1, bc2 = bias_corrections(b1, b2, t)
            step = (m / bc1) / (torch.sqrt(v / bc2) + hp["eps"]) \
                + hp["weight_decay"] * params
            return params - hp["lr"] * step, {"m": m, "v": v}
        raise ValueError(f"unknown flat optimizer {self.name!r}")


def bias_corrections(b1: float, b2: float, t: torch.Tensor):
    """AdamW's ``1 - b ** t`` for both moments, in f32 on ``t``'s device
    (no host sync), as the reference computes them (``engine.py:706``)."""
    t32 = t.float()
    return 1 - b1 ** t32, 1 - b2 ** t32


def flat_sgd(lr: float) -> FlatOptimizer:
    return FlatOptimizer("sgd", (("lr", lr),))


def flat_momentum_sgd(lr: float, beta: float = 0.9, nesterov: bool = False) -> FlatOptimizer:
    return FlatOptimizer("momentum", (("lr", lr), ("beta", beta), ("nesterov", nesterov)))


def flat_adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> FlatOptimizer:
    return FlatOptimizer("adamw", (("lr", lr), ("b1", b1), ("b2", b2), ("eps", eps),
                                   ("weight_decay", weight_decay)))


# registry: optimizer name -> flat factory
FLAT_OPTIMIZERS = {
    "sgd": flat_sgd,
    "momentum": flat_momentum_sgd,
    "adamw": flat_adamw,
}


def flat_twin(opt) -> FlatOptimizer:
    """The flat twin of an ``Optimizer`` (a ``FlatOptimizer`` passes through
    unchanged), rebuilt from its recorded hyperparameters."""
    if isinstance(opt, FlatOptimizer):
        return opt
    try:
        factory = FLAT_OPTIMIZERS[opt.name]
    except KeyError:
        raise ValueError(f"optimizer {opt.name!r} has no flat twin; registered: "
                         f"{tuple(FLAT_OPTIMIZERS)}") from None
    return factory(**dict(opt.hparams))
