"""Params between the port's layout and the reference's.

The port keeps a dense model's params as ``{"embed", "layers", "ln_f"}``
with ``layers`` a list of per-layer block dicts.  The reference stacks each
block leaf on a leading ``[n_groups]`` axis under ``stack.groups[0]`` (for
a dense model one group is one layer): entry ``g`` of that axis is
``layers[g]``.  Every leaf keeps its layout (``kernel`` stays
``[d_in, d_out]``).

* ``params_from_numpy`` takes the pytree of ``repro.models.lm_init`` as
  numpy arrays and builds the port's params as f32 tensors on ``device``;
* ``params_from_stacked`` cuts a tree of the reference's layout into the
  port's layout by views (no copy): how the train step feeds the model
  from the flat master vector;
* ``stack_params`` is its inverse (a copy), the tree the flat layout
  (``core.flatten``) is defined over.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig

_BLOCK_KEYS = ["attn", "ln1", "ln2", "mlp"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)   # a writable copy


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_stacked(tree: dict, cfg: ModelConfig) -> dict:
    """The port's params from a tree of the reference's layout (leaves are
    tensors, block leaves stacked ``[num_layers, ...]``); every leaf of the
    result is a view of a leaf of ``tree``."""
    stack = tree["stack"]
    group = stack["groups"][0]
    if (stack.get("prefix") or stack.get("shared_attn") is not None
            or len(stack["groups"]) != 1 or ("head" in tree) == cfg.tie_embeddings
            or sorted(group) != _BLOCK_KEYS
            or group["ln1"]["scale"].shape[0] != cfg.num_layers):
        tied = "tied" if cfg.tie_embeddings else "untied"
        raise ValueError(f"expected the params of a dense {cfg.num_layers}-layer model "
                         f"with {tied} embeddings")
    params = {
        "embed": tree["embed"],
        "layers": [_map(group, lambda a, g=g: a[g]) for g in range(cfg.num_layers)],
        "ln_f": tree["ln_f"],
    }
    if "head" in tree:
        params["head"] = tree["head"]
    return params


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    return params_from_stacked(_map_tree(tree, lambda a: _tensor(a, device)), cfg)


def _map_tree(tree, fn):
    """``fn`` over the array leaves of a reference pytree (dicts, lists,
    ``None``)."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def stack_params(params: dict) -> dict:
    """The reference's tree layout of the port's params: block leaves
    stacked on a leading ``[num_layers]`` axis (a copy)."""
    layers = params["layers"]

    def stacked(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stacked(*(x[k] for x in leaves)) for k in leaves[0]}
        return torch.stack(leaves)

    tree = {"embed": params["embed"], "ln_f": params["ln_f"],
            "stack": {"groups": [stacked(*layers)], "prefix": [], "shared_attn": None}}
    if "head" in params:
        tree["head"] = params["head"]
    return tree
