"""Weights carried across from the JAX package.

Both packages keep the same parameter layout as the JAX `model.init`
(`lstm0.{wx,wh,b}`, `head.{w,b}`), so a tree of numpy arrays moves
between them leaf for leaf. The JAX side does
`jax.tree.map(np.asarray, params)` before handing the tree over; this
module only ever sees numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device) -> dict:
    """Nested dict of numpy arrays → the same dict of torch tensors on
    `device` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree) -> dict:
    """Inverse of `params_from_numpy`: tensors → host numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
