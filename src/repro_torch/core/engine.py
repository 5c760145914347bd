"""ServerEngine: the DuDe server iteration on one flat buffer layout
(``repro.core.engine``).

``DuDeEngine`` owns the server state in one layout: ``g_bar`` as a padded
flat ``[P]`` f32 vector, ``g_workers``/``inflight`` as ``[n, P]`` slabs in
the configured buffer dtype (``core/flatten.py``).  It exposes the
semi-async ``round`` and ``round_apply``, the round fused with a flat
optimizer step on ``[P]`` master params, over two backends:

* ``"reference"`` — the masked sweep over all n rows, then
  ``FlatOptimizer.update``: the plain oracle.  Its commit sum runs over
  the rows in order, as K1's does, so the two backends agree bitwise on
  ``g_bar``.
* ``"pallas"`` — the reference's name for its fused kernel, kept as the
  config value: here the fused round K1 (``kernels.ops.dude_round_apply``,
  ``csrc/dude_update.cu``), one pass over every stream, the optimizer step
  included.  On CUDA tensors it launches the kernel; on CPU tensors it runs
  the kernel's plain version.

The pallas backend updates the state, the params and the slots in place
(the reference donates its state to the step for the same reason: at full
width the slabs fill most of the card).  The reference backend returns new
tensors.

The slice runs the f32 slab format on one device.  The indexed backend,
the accumulate latch, the compressed commit formats, the sparse metadata,
the per-arrival ``commit`` and the mesh are not yet ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..kernels import ops
from ..optim.transforms import FlatOptimizer, FlatOptState, bias_corrections
from .flatten import FlatSpec, make_flat_spec

__all__ = ["BACKENDS", "EngineState", "DuDeEngine"]

BACKENDS = ("reference", "pallas")


class EngineState(NamedTuple):
    """Flat DuDe server state (the f32 format's fields of the reference)."""

    g_bar: torch.Tensor      # [P] f32 running aggregated gradient (paper g~)
    g_workers: torch.Tensor  # [n, P] latest committed gradient per worker
    inflight: torch.Tensor   # [n, P] gradient latched at job start
    acc_count: torch.Tensor  # [n] i32 rounds since each worker's job start
    step: torch.Tensor       # scalar i32 server iteration counter


def _not_yet_ported(what: str):
    return NotImplementedError(f"DuDeEngine: {what} is not yet ported")


@dataclasses.dataclass(frozen=True)
class DuDeEngine:
    """One DuDe server, one flat state layout, two update backends."""

    spec: FlatSpec
    n_workers: int
    buffer_dtype: torch.dtype = torch.float32
    backend: str = "reference"
    device: Any = "cuda"
    accumulate: bool = False
    commit_format: str = "f32"
    sparse_meta: bool = False
    mesh: Any = None

    def __post_init__(self):
        if self.backend == "indexed":
            raise _not_yet_ported("the indexed backend")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; options: {BACKENDS}")
        if self.accumulate:
            raise _not_yet_ported("accumulate mode")
        if self.commit_format != "f32":
            raise _not_yet_ported(f"commit_format {self.commit_format!r}")
        if self.sparse_meta:
            raise _not_yet_ported("sparse_meta")
        if self.mesh is not None:
            raise _not_yet_ported("the mesh")
        if self.buffer_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"buffer_dtype {self.buffer_dtype} is not f32 or bf16")

    @classmethod
    def for_tree(cls, grad_like, n_workers: int, **kw) -> "DuDeEngine":
        """Engine whose flat layout matches ``grad_like``'s tree layout."""
        return cls(spec=make_flat_spec(grad_like), n_workers=n_workers, **kw)

    @property
    def P(self) -> int:
        return self.spec.padded_size

    def init(self) -> EngineState:
        n, P, dev = self.n_workers, self.P, self.device
        return EngineState(
            g_bar=torch.zeros((P,), dtype=torch.float32, device=dev),
            g_workers=torch.zeros((n, P), dtype=self.buffer_dtype, device=dev),
            inflight=torch.zeros((n, P), dtype=self.buffer_dtype, device=dev),
            acc_count=torch.zeros((n,), dtype=torch.int32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _advance(self, state: EngineState, g_bar, gw, infl, sm) -> EngineState:
        acc = torch.where(sm, 1, state.acc_count + 1).to(torch.int32)
        return state._replace(g_bar=g_bar, g_workers=gw, inflight=infl, acc_count=acc,
                              step=state.step + 1)

    def round(self, state: EngineState, fresh: torch.Tensor, start_mask,
              commit_mask) -> tuple[EngineState, torch.Tensor]:
        """Semi-async round on flat slabs (paper §3): ``fresh`` [n, P] is the
        live-model gradient; ``start_mask`` latches it into ``inflight``,
        ``commit_mask`` folds ``inflight - g_workers`` into ``g_bar``.
        Returns ``(state, g_bar)``.  The pallas backend runs K1 with a zero
        learning rate on a scratch parameter vector, as the reference's
        ``_round_pallas`` does."""
        sm, cm = start_mask.to(torch.bool), commit_mask.to(torch.bool)
        if self.backend == "pallas":
            gw, infl, g_bar, _, _ = ops.dude_round_apply(
                cm, sm, fresh, state.g_workers, state.inflight, state.g_bar,
                torch.zeros_like(state.g_bar), kind="sgd", hp=(("lr", 0.0),))
        else:
            g_bar, gw, infl = self._round_reference(state, fresh, sm, cm)
        return self._advance(state, g_bar, gw, infl, sm), g_bar

    def round_apply(self, state: EngineState, fresh: torch.Tensor, start_mask,
                    commit_mask, params: torch.Tensor, opt_state: FlatOptState,
                    opt: FlatOptimizer):
        """The DuDe round fused with the flat optimizer step on the ``[P]``
        f32 master ``params``.  The pallas backend streams the slots through
        K1, with AdamW's bias corrections computed on the device from the
        step counter; the reference backend runs the round, then
        ``opt.update``.  Returns ``(state', g_bar, params', opt_state')``."""
        sm, cm = start_mask.to(torch.bool), commit_mask.to(torch.bool)
        t_new = opt_state.step + 1
        slots = opt_state.slots
        if self.backend == "pallas":
            bc = None
            if opt.name == "adamw":
                bc = torch.stack(bias_corrections(opt.hp["b1"], opt.hp["b2"], t_new))
            leaves = (() if opt.name == "sgd" else (slots,) if opt.name == "momentum"
                      else (slots["m"], slots["v"]))
            gw, infl, g_bar, w_new, _ = ops.dude_round_apply(
                cm, sm, fresh, state.g_workers, state.inflight, state.g_bar, params,
                leaves, bc, kind=opt.name, hp=opt.hparams)
            sl_new = slots
        else:
            g_bar, gw, infl = self._round_reference(state, fresh, sm, cm)
            w_new, sl_new = opt.update(params, g_bar, slots, t_new)
        st = self._advance(state, g_bar, gw, infl, sm)
        return st, g_bar, w_new, FlatOptState(t_new, sl_new)

    def _round_reference(self, state: EngineState, fresh, sm, cm):
        """Masked full sweep over all n rows (the paper-faithful oracle)."""
        g32 = fresh.float()
        infl32 = state.inflight.float()
        gw32 = state.g_workers.float()
        delta = cm.float()[:, None] * (infl32 - gw32)
        total = torch.zeros_like(state.g_bar)
        for row in delta:                 # in row order, as K1 sums
            total = total + row
        g_bar = state.g_bar + total / self.n_workers
        bdt = state.g_workers.dtype
        gw = torch.where(cm[:, None], infl32.to(bdt), state.g_workers)
        infl = torch.where(sm[:, None], g32.to(bdt), state.inflight)
        return g_bar, gw, infl
