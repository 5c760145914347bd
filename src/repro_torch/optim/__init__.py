"""Optimizers of the port: descriptors and their flat-slab twins."""

from .transforms import (
    FLAT_OPTIMIZERS,
    FlatOptimizer,
    FlatOptState,
    FlatTrainState,
    Optimizer,
    adamw,
    bias_corrections,
    flat_adamw,
    flat_momentum_sgd,
    flat_sgd,
    flat_twin,
    momentum_sgd,
    sgd,
)

__all__ = [
    "Optimizer", "sgd", "momentum_sgd", "adamw", "bias_corrections",
    "FlatOptState", "FlatOptimizer", "FlatTrainState",
    "flat_sgd", "flat_momentum_sgd", "flat_adamw",
    "FLAT_OPTIMIZERS", "flat_twin",
]
