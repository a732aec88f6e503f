"""Batch padding for fixed-size batches.

The port's own copy of ``pad_to_multiple`` from
``vit_grid_model_tpu/parallel/mesh.py``; the rest of that module (meshes,
shardings, the sharded ragged tail) is data-parallel work not ported yet.
"""

from __future__ import annotations

import numpy as np


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    """The first leaf in JAX's order: dicts by sorted key."""
    while isinstance(tree, (dict, tuple, list)):
        tree = tree[min(tree)] if isinstance(tree, dict) else tree[0]
    return tree


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis of every array in ``batch`` (a tuple, list or
    dict of arrays, nested or not) to a multiple of ``multiple`` by
    repeating the last sample.  Returns (padded_batch, real_count).

    What fills the pad matters beyond the shape: the model's time
    conditioning mixes embeddings across the rows of a batch (reference
    quirk #11), so the real samples' outputs depend on the padded ones."""
    def pad(x):
        b = x.shape[0]
        rem = (-b) % multiple
        if rem == 0:
            return x
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)

    return _tree_map(pad, batch), _first_leaf(batch).shape[0]
