"""Step builders of the port (``repro.launch.steps``): the semi-async DuDe
train step on the flat train state, and the serving steps.

train step semantics (one round, one device, params replicated):
  1. every worker computes the gradient of the live model on its own
     heterogeneous shard — the reference vmaps one backward over the worker
     axis; the port loops over the n workers and writes each worker's f32
     gradient into row ``i`` of the ``[n, P]`` fresh slab;
  2. ``engine.round_apply`` folds the commits, latches the starting
     workers' rows and steps the flat optimizer on the ``[P]`` master params
     (one fused K1 pass on the pallas backend).

The forward reads the params as views of the flat master vector
(``core.flatten`` + ``models.convert.params_from_stacked``): no copy, and
the flat layout is the reference's leaf for leaf.  The loss stays a device
tensor; nothing in a step waits for the device.  The reference jits and
shards these closures; the port runs them eagerly on one device.  Meshes,
the other round rules and the TP layout are not yet ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.algos import RoundAlgo, make_round_algo
from ..core.dude import DuDeConfig
from ..core.engine import DuDeEngine
from ..core.flatten import tree_flatten, tree_unflatten
from ..models.config import ModelConfig
from ..models.convert import params_from_stacked, stack_params
from ..models.model import decode_step, lm_init, loss_fn, prefill
from ..optim import FlatTrainState, flat_twin, sgd


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's param tree of ``cfg`` as meta tensors (shapes, f32
    master dtypes; the reference keeps bf16 masters only above 50B
    params, sizes the port does not run)."""
    return stack_params(lm_init(torch.Generator(), cfg, "meta"))


def make_engine(cfg: ModelConfig, dude_cfg: Optional[DuDeConfig] = None, *,
                backend: str = "reference", device="cuda") -> DuDeEngine:
    """The ServerEngine the train step runs, over the flat layout of
    ``cfg``'s params."""
    dude_cfg = dude_cfg or DuDeConfig(cfg.n_workers, cfg.dude_buffer_dtype)
    return DuDeEngine.for_tree(
        abstract_params(cfg), dude_cfg.n_workers,
        buffer_dtype=dude_cfg.buffer_dtype or torch.float32, backend=backend, device=device)


def make_train_step(cfg: ModelConfig, opt=None, dude_cfg: Optional[DuDeConfig] = None, *,
                    engine: Optional[DuDeEngine] = None,
                    algo: Optional[RoundAlgo] = None,
                    grad_dtype: Optional[torch.dtype] = None) -> Callable:
    """The round step on the flat train state:
    ``(state: FlatTrainState, batch, sm, cm) -> (state, metrics)``.

    ``batch`` holds worker-stacked ``tokens``/``labels`` ``[n, B, S]`` and
    the masks are ``[n]`` bool, all on the engine's device.  ``grad_dtype``
    (default f32) is the dtype of the fresh slab.  The metrics are device
    tensors: ``loss`` (the mean over workers) and ``applied``."""
    opt = opt or sgd(0.01)
    engine = engine or make_engine(cfg, dude_cfg)
    algo = algo or make_round_algo("dude", engine)
    if not algo.fused_apply:
        raise NotImplementedError(f"round algo {algo.name!r} is not yet ported")
    spec, fopt = engine.spec, flat_twin(opt)
    gdt = grad_dtype or torch.float32

    def model_params(flat: torch.Tensor, cast: bool = True) -> dict:
        """The port's params as views of a flat ``[P]`` vector."""
        return params_from_stacked(spec.unravel(flat, cast=cast), cfg)

    def fresh_grads(pf: torch.Tensor, batch: dict):
        """One backward per worker -> the ``[n, P]`` fresh slab (pad lanes
        zero) and the ``[n]`` per-worker losses."""
        n = batch["tokens"].shape[0]
        fresh = torch.empty((n, engine.P), dtype=gdt, device=pf.device)
        fresh[:, spec.size:].zero_()
        views, paths = tree_flatten(model_params(pf))
        losses = []
        for i in range(n):
            leaves = [v.detach().requires_grad_() for v in views]
            total, metrics = loss_fn(tree_unflatten(paths, leaves),
                                     {k: x[i] for k, x in batch.items()}, cfg)
            grads = torch.autograd.grad(total, leaves)
            for dst, g in zip(tree_flatten(model_params(fresh[i], cast=False))[0], grads):
                dst.copy_(g)
            losses.append(metrics["loss"].detach())
        return fresh, torch.stack(losses)

    def flat_train_step(state: FlatTrainState, batch: dict, start_mask, commit_mask):
        fresh, losses = fresh_grads(state.params, batch)
        srv, _, pf_new, opt_new = engine.round_apply(
            state.engine, fresh, start_mask, commit_mask, state.params, state.opt, fopt)
        metrics = {"loss": losses.mean(),
                   "applied": torch.ones((), device=losses.device)}
        return FlatTrainState(pf_new, opt_new, srv), metrics

    return flat_train_step


def init_flat_train_state(engine: DuDeEngine, opt, params: dict,
                          algo: Optional[RoundAlgo] = None) -> FlatTrainState:
    """Concrete ``FlatTrainState`` from the port's params: ravel the masters
    to the f32 ``[P]`` vector, zero the flat optimizer slots and the server
    state (the engine's ``EngineState`` by default)."""
    pf = engine.spec.ravel(stack_params(params), torch.float32)
    srv = algo.init() if algo is not None else engine.init()
    return FlatTrainState(pf, flat_twin(opt).init(pf), srv)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, caches):
        return prefill(params, batch, caches, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, use_window: bool = False) -> Callable:
    def serve_step(params, tokens, caches, index: int):
        return decode_step(params, tokens, caches, index, cfg, use_window=use_window)

    return serve_step
