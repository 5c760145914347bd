"""Pytree <-> flat-buffer ravel layer for the ServerEngine
(``repro.core.flatten``).

The DuDe server iteration is elementwise over Theta(n * p) buffer state, so
the engine stores all of it as padded flat slabs: ``g_bar`` as ``[P]`` and
the per-worker buffers as ``[n, P]``, where ``P`` is the total parameter
count rounded up to ``PAD_MULTIPLE``.  A ``FlatSpec`` records, per leaf,
its key path, shape, dtype, size and offset into the flat vector.  Padding
is zero-filled and ignored on unravel; zero is a fixed point of every
engine update, so the pad lanes never touch real state.

The layout is the reference's, leaf for leaf: leaves are ordered as
``jax.tree_util`` orders them (dict keys sorted, list entries in order,
``None`` holds no leaf), over the reference's param tree, in which every
block leaf of a dense model is stacked ``[num_layers, ...]`` under
``stack.groups[0]`` (``models.convert.stack_params`` /
``abstract_params``).  Layer ``l`` of a stacked leaf is then one contiguous
range of the flat vector, so ``unravel`` hands out views of it and
``models.convert.params_from_stacked`` cuts them into the port's per-layer
dicts without a copy.

The mesh-sharded layout (``mesh_axis_size``, ``shard_ranges``) and the
TP-native exchange of the reference wait for the port's mesh support.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["FlatSpec", "make_flat_spec", "PAD_MULTIPLE", "tree_flatten",
           "tree_unflatten"]

# Lane width of the TPU vector unit in the reference; kept so that the flat
# layout (and every offset and padded size) is the reference's.
PAD_MULTIPLE = 128

Tree = Any


def tree_flatten(tree: Tree, path: tuple = ()) -> tuple[list, list]:
    """``(leaves, paths)`` of a tree of dicts, lists and tensors, in
    ``jax.tree_util`` order: dict keys sorted, list and tuple entries in
    order, ``None`` holding no leaf.  A path is the tuple of keys and list
    indices from the root to its leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [tree], [path]
    leaves, paths = [], []
    for k, sub in items:
        lv, ps = tree_flatten(sub, path + (k,))
        leaves += lv
        paths += ps
    return leaves, paths


def tree_unflatten(paths, leaves) -> Tree:
    """The nested dicts and lists that ``tree_flatten`` reads back as
    ``(leaves, paths)``.  Containers without leaves are not rebuilt."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(root)


def _lists(node):
    """Dicts whose keys are exactly 0..k-1 (list indices) back to lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out) and sorted(out) == list(range(len(out))):
        return [out[i] for i in range(len(out))]
    return out


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Segment table mapping one tree layout to a padded flat vector."""

    paths: tuple           # per-leaf key paths (tree_flatten order)
    shapes: tuple          # per-leaf shapes
    dtypes: tuple          # per-leaf dtypes (restored on unravel)
    sizes: tuple           # per-leaf element counts
    offsets: tuple         # per-leaf start offset into the flat vector
    size: int              # sum(sizes), before padding
    padded_size: int       # P: size rounded up to PAD_MULTIPLE

    def _leaves(self, tree: Tree) -> list:
        leaves, paths = tree_flatten(tree)
        if tuple(paths) != self.paths:
            raise ValueError("tree does not have the spec's layout: "
                             f"{len(paths)} leaves vs {len(self.paths)}")
        return leaves

    def ravel(self, tree: Tree, dtype=torch.float32) -> torch.Tensor:
        """Tree with leaves of ``self.shapes`` -> flat ``[P]`` in ``dtype``."""
        flat = [x.to(dtype).reshape(-1) for x in self._leaves(tree)]
        return self._pad(torch.cat(flat))

    def ravel_stacked(self, tree: Tree, dtype=torch.float32) -> torch.Tensor:
        """Tree with ``[n, *shape]`` leaves -> ``[n, P]`` in ``dtype``."""
        leaves = self._leaves(tree)
        n = leaves[0].shape[0]
        flat = [x.to(dtype).reshape(n, -1) for x in leaves]
        return self._pad(torch.cat(flat, dim=-1))

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        pad = self.padded_size - self.size
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def unravel(self, flat: torch.Tensor, cast: bool = True) -> Tree:
        """Flat ``[P]`` -> tree with the spec's shapes (and dtypes if
        ``cast``).  Each leaf is a view of ``flat`` where no cast is needed
        (f32 masters unravelled from an f32 vector): writes to it write the
        flat vector."""
        leaves = []
        for off, sz, shp, dt in zip(self.offsets, self.sizes, self.shapes,
                                    self.dtypes):
            x = flat[off:off + sz].view(shp)
            leaves.append(x.to(dt) if cast else x)
        return tree_unflatten(self.paths, leaves)


def make_flat_spec(tree: Tree, pad_multiple: int = PAD_MULTIPLE) -> FlatSpec:
    """The FlatSpec of ``tree``'s layout.  ``tree`` may hold real or meta
    tensors; only paths, shapes and dtypes matter."""
    leaves, paths = tree_flatten(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    sizes = tuple(x.numel() for x in leaves)
    offsets, off = [], 0
    for sz in sizes:
        offsets.append(off)
        off += sz
    padded = max(pad_multiple, -(-off // pad_multiple) * pad_multiple)
    return FlatSpec(tuple(paths), shapes, tuple(x.dtype for x in leaves), sizes,
                    tuple(offsets), off, padded)
