"""Weights carried across from the JAX package.

Both packages keep the same parameter layout as the JAX `model.init`
(`lstm0.{wx,wh,b}`, `head.{w,b}`; the TFT's `emb_past` and
`vsn_past_var` are lists of dicts), so a tree of numpy arrays moves
between them leaf for leaf. The JAX side does
`jax.tree.map(np.asarray, params)` before handing the tree over; this
module only ever sees numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map


def params_from_numpy(tree, device):
    """Nested dicts and lists of numpy arrays → the same tree of torch
    tensors on `device` (dtypes kept)."""
    return tree_map(
        lambda v: torch.from_numpy(np.array(v, copy=True)).to(device), tree)


def params_to_numpy(tree):
    """Inverse of `params_from_numpy`: tensors → host numpy arrays."""
    return tree_map(lambda v: v.detach().cpu().numpy(), tree)
