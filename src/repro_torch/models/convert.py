"""Params carried across from the reference: ``params_from_numpy`` takes
the pytree of ``repro.models.lm_init`` as numpy arrays and builds the
port's params.

The reference stacks each block leaf on a leading ``[n_groups]`` axis under
``stack.groups[0]`` (for a dense model one group is one layer); entry ``g``
of that axis becomes ``layers[g]``.  Every leaf keeps its layout
(``kernel`` stays ``[d_in, d_out]``) and becomes an f32 tensor on
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)   # a writable copy


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    stack = tree["stack"]
    group = stack["groups"][0]
    if (stack["prefix"] or stack["shared_attn"] is not None or len(stack["groups"]) != 1
            or "head" in tree or sorted(group) != ["attn", "ln1", "ln2", "mlp"]
            or group["ln1"]["scale"].shape[0] != cfg.num_layers):
        raise ValueError(f"expected the params of a dense {cfg.num_layers}-layer model "
                         f"with tied embeddings")
    return {
        "embed": _map(tree["embed"], lambda a: _tensor(a, device)),
        "layers": [_map(group, lambda a, g=g: _tensor(a[g], device))
                   for g in range(cfg.num_layers)],
        "ln_f": _map(tree["ln_f"], lambda a: _tensor(a, device)),
    }
