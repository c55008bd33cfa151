"""Model checkpoints in the JAX package's directory layout:

    <root>/<tenant>/<model_name>/v<N>/params.npz + metadata.json

`params.npz` holds one array per leaf, keyed as `jax.tree_util.keystr`
writes a path: `['lstm0']['wx']` for dict keys, `[0]` for list indices
(`['emb_past'][0]['w']`). That is the JAX `CheckpointStore`'s npz
layout, which its `load` reads whenever a version has no `params/`
directory. The JAX package writes Orbax trees (`v<N>/params/`) when
Orbax is installed; the port cannot read those and says so. The JAX npz
reader keeps dict keys only, so it reads the port's list-free trees
(`lstm`, `seasonal`, `gnn`, ...) but not a TFT's.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Optional

import numpy as np
from torch.utils._pytree import keystr, tree_flatten_with_path

logger = logging.getLogger(__name__)

_KEY = re.compile(r"\['([^']+)'\]|\[(\d+)\]")


def _flatten(tree) -> dict[str, np.ndarray]:
    """Leaves by keystr path; torch tensors come back as numpy."""
    return {keystr(path): np.asarray(leaf.detach().cpu().numpy()
                                     if hasattr(leaf, "detach") else leaf)
            for path, leaf in tree_flatten_with_path(tree)[0]}


def _unflatten(flat: dict[str, np.ndarray]):
    """Inverse of `_flatten`: `[i]` steps build lists, `['k']` dicts."""
    root: dict = {}
    for path, leaf in flat.items():
        steps = [m.group(1) if m.group(1) is not None else int(m.group(2))
                 for m in _KEY.finditer(path)]
        if "".join(m.group(0) for m in _KEY.finditer(path)) != path or not steps:
            raise ValueError(f"checkpoint key {path!r} is not a keystr path")
        node = root
        for step in steps[:-1]:
            node = node.setdefault(step, {})
        node[steps[-1]] = leaf
    return _lists(root)


def _lists(node):
    """Turn dicts keyed 0..n-1 by int (list steps) into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices {sorted(out)} are not 0..n-1")
        return [out[i] for i in range(len(out))]
    return out


class CheckpointStore:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _model_dir(self, tenant_id: str, model_name: str) -> str:
        d = os.path.join(self.root, tenant_id, model_name)
        os.makedirs(d, exist_ok=True)
        return d

    def versions(self, tenant_id: str, model_name: str) -> list[int]:
        d = self._model_dir(tenant_id, model_name)
        out = []
        for name in os.listdir(d):
            m = re.fullmatch(r"v(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, tenant_id: str, model_name: str, params: Any,
             metadata: Optional[dict] = None) -> int:
        """Save params (a tree of tensors or numpy arrays) as the next
        version; returns the version number."""
        versions = self.versions(tenant_id, model_name)
        version = (versions[-1] + 1) if versions else 1
        d = os.path.join(self._model_dir(tenant_id, model_name), f"v{version}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "params.npz"), **_flatten(params))
        meta = {"version": version, "saved_at": time.time(),
                "model": model_name, **(metadata or {})}
        with open(os.path.join(d, "metadata.json"), "w") as f:
            json.dump(meta, f)
        logger.info("checkpoint %s/%s v%d saved", tenant_id, model_name, version)
        return version

    def load(self, tenant_id: str, model_name: str,
             version: Optional[int] = None) -> tuple[Any, dict]:
        """Load (params as a numpy tree, metadata) for a version (default:
        latest). A version written as an Orbax tree raises."""
        versions = self.versions(tenant_id, model_name)
        if not versions:
            raise FileNotFoundError(
                f"no checkpoints for {tenant_id}/{model_name} under {self.root}")
        version = version if version is not None else versions[-1]
        d = os.path.join(self._model_dir(tenant_id, model_name), f"v{version}")
        with open(os.path.join(d, "metadata.json")) as f:
            meta = json.load(f)
        npz = os.path.join(d, "params.npz")
        if not os.path.isfile(npz) and os.path.isdir(os.path.join(d, "params")):
            raise ValueError(
                f"{d} holds an Orbax checkpoint (params/), which this "
                "package cannot read; save it in the npz layout "
                "(params.npz with keystr keys)")
        with np.load(npz) as data:
            params = _unflatten({k: data[k] for k in data.files})
        return params, meta

    def prune(self, tenant_id: str, model_name: str, keep: int = 3) -> None:
        """Delete all but the newest `keep` versions."""
        versions = self.versions(tenant_id, model_name)
        for v in versions[:-keep] if keep > 0 else versions:
            shutil.rmtree(os.path.join(
                self._model_dir(tenant_id, model_name), f"v{v}"),
                ignore_errors=True)
